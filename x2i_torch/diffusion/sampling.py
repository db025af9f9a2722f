"""Latent packing and the denoising loop, the counterpart of
``x2i_tpu/diffusion/sampling.py``. The JAX ``lax.scan`` over steps is a
Python loop here."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler


def prepare_latent_image_ids(height: int, width: int,
                             device=None) -> torch.Tensor:
    """(h/2 * w/2, 3) f32 position ids: [:,0]=0, [:,1]=row, [:,2]=col.
    height/width are the latent grid dims."""
    h2, w2 = height // 2, width // 2
    ids = torch.zeros((h2, w2, 3), dtype=torch.float32, device=device)
    ids[..., 1] += torch.arange(h2, dtype=torch.float32, device=device)[:, None]
    ids[..., 2] += torch.arange(w2, dtype=torch.float32, device=device)[None, :]
    return ids.reshape(h2 * w2, 3)


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H/2*W/2, C*4), 2x2 patchify."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(x: torch.Tensor, height: int, width: int,
                   vae_scale_factor: int = 8) -> torch.Tensor:
    """Inverse of pack_latents for *pixel* dims -> (B, C, h, w)."""
    b, _, ch = x.shape
    h = 2 * (height // (vae_scale_factor * 2))
    w = 2 * (width // (vae_scale_factor * 2))
    c = ch // 4
    x = x.reshape(b, h // 2, w // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def denoise(model_fn: Callable[..., torch.Tensor], latents: torch.Tensor,
            prompt_embeds: torch.Tensor, pooled_embeds: torch.Tensor,
            sigmas: torch.Tensor, img_ids: torch.Tensor,
            txt_ids: torch.Tensor, guidance_scale: Optional[float] = None,
            mods: Optional[dict] = None) -> torch.Tensor:
    """Euler steps over ``sigmas`` (num_steps + 1,) f32.

    model_fn(latents, prompt, pooled, timestep, img_ids, txt_ids,
    guidance|None[, mods]) -> velocity. mods: optional precomputed adaLN
    modulations with a leading num_steps axis on each entry; step i gets
    ``{k: v[i]}``."""
    batch = latents.shape[0]
    guidance = (None if guidance_scale is None else
                torch.full((batch,), guidance_scale, dtype=torch.float32,
                           device=latents.device))
    for i in range(sigmas.shape[0] - 1):
        timestep = sigmas[i].expand(batch)
        args = (latents, prompt_embeds, pooled_embeds, timestep, img_ids,
                txt_ids, guidance)
        if mods is None:
            vel = model_fn(*args)
        else:
            vel = model_fn(*args, {k: v[i] for k, v in mods.items()})
        latents = FlowMatchEulerScheduler.step(latents, vel, sigmas[i],
                                               sigmas[i + 1])
    return latents


def denoise_flux(model, noise, prompt_embeds, pooled_embeds, sigmas,
                 img_ids, txt_ids, guidance_scale: Optional[float] = None,
                 precompute_mods: bool = True,
                 control_fn: Optional[Callable] = None,
                 control_pixels: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """denoise() over a FluxTransformer2D, with every step's adaLN
    modulations computed in one pass first (each modulation weight read
    once per image instead of once per step). With ``control_fn``
    (LightControl), every step's DiT call takes
    ``controls=control_fn(control_pixels, t * 1000)``."""
    def model_fn(lat, pr, po, t, iid, tid, g, mods=None):
        controls = (None if control_fn is None
                    else control_fn(control_pixels, t * 1000.0))
        return model(lat, pr, po, t, iid, tid, guidance=g,
                     precomputed_mods=mods, controls=controls)

    mods = None
    if precompute_mods:
        guidance = (None if guidance_scale is None else
                    torch.full((noise.shape[0],), guidance_scale,
                               dtype=torch.float32, device=noise.device))
        mods = model(noise, prompt_embeds, pooled_embeds, sigmas[:-1],
                     img_ids, txt_ids, guidance=guidance, mods_only=True)
    return denoise(model_fn, noise, prompt_embeds, pooled_embeds, sigmas,
                   img_ids, txt_ids, guidance_scale=guidance_scale,
                   mods=mods)
