"""Trainer harnesses: the tiny end-to-end trainers (the counterparts of
``build_tiny_distill`` and ``build_tiny_lightcontrol`` in
``x2i_tpu/train/harness.py``) and the full-width ones with random weights
drawn on the card.

``build_tiny_distill`` has the JAX harness's configs, batch and fixed
T5-widening projection (the same numpy draws from the same seed); its
weights come from the JAX param trees through the bridge when ``trees``
is given, so that the two trainers can be compared step by step, else
from a torch.Generator. ``build_random_distill("full", ...)`` builds
x2i-internvl2.5-1b's phase-1 trainer at full width and depth in bf16: the
Qwen2.5-0.5B LM, the internvl1b proj, FLUX.1-schnell (remat on, rope
outside the kernel, no fused glue, as the JAX ``assemble_distill`` sets
it), T5-XXL's encoder and CLIP-L's text tower. It can take an LM and a DiT
that already exist (a serving pipeline's), so that no second copy of the
12B weights is made.

``build_tiny_lightcontrol`` has the JAX harness's phase-2 configs and
batch (a /8 VAE, so that the bank's tokens are the packed latents');
``build_random_lightcontrol("full", ...)`` builds the phase-2 trainer on a
serving pipeline's DiT, VAE and encoder with the 19-branch bank at its
reference widths drawn on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from x2i_torch.core.config import (MODEL_REGISTRY, CLIPTextConfig,
                                   ControlNeXtConfig, DistillConfig,
                                   LightControlConfig, ProjConfig,
                                   SchedulerConfig, T5Config, VAEConfig,
                                   tiny_flux_config, tiny_qwen2_config)
from x2i_torch.models.clip import CLIPTextEncoder
from x2i_torch.models.controlnext import ControlBank
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.t5 import T5Encoder
from x2i_torch.models.vae import AutoencoderKL
from x2i_torch.params import load_flax, load_flax_bank, random_init_
from x2i_torch.pipeline import resolve_device
from x2i_torch.train.distill import (init_state, make_distill_step,
                                     make_optimizer, make_student_step,
                                     make_teacher_step)
from x2i_torch.train.lightcontrol import (init_state as init_control_state,
                                          make_lightcontrol_optimizer,
                                          make_lightcontrol_step)
from x2i_torch.train.single_chip import single_chip_distill

# the full-width run's prompts: this many real tokens, right-padded
REAL_TOKENS = 40


def wire_distill(flux, lm, t5, clip, proj, widen, flux_cfg, dcfg,
                 split=False, slim_handoff=False, student_states_fn=None):
    """The trainer around the five modules: -> (step, state, parts); the
    split step is the (teacher_fn, student_fn) pair, the slim one that of
    ``single_chip_distill``. ``student_states_fn(batch)``: the MLLM's
    hidden-state stack (by default ``lm``'s text prefill; ``lm`` is then
    any frozen module, e.g. a whole encoder)."""
    for frozen in (flux, lm, t5, clip):
        frozen.requires_grad_(False)

    def teacher_text_fn(b):
        seq = t5(b["t5_ids"], b["t5_mask"])
        if widen is not None:
            seq = seq @ widen
        _, pooled = clip(b["clip_ids"])
        return seq, pooled

    def lm_states(b):
        states, _ = lm(b["mllm_ids"], attention_mask=b["mllm_mask"])
        return states

    student_states_fn = student_states_fn or lm_states

    optimizer = make_optimizer(dcfg)
    state = init_state(proj, optimizer)
    parts = {"flux": flux, "lm": lm, "t5": t5, "clip": clip, "proj": proj,
             "teacher_text_fn": teacher_text_fn,
             "student_states_fn": student_states_fn,
             "optimizer": optimizer, "flux_cfg": flux_cfg, "dcfg": dcfg}
    if split and slim_handoff:
        step = single_chip_distill(flux, teacher_text_fn, student_states_fn,
                                   optimizer, flux_cfg, dcfg)[1:]
    elif split:
        step = (make_teacher_step(flux, teacher_text_fn, student_states_fn,
                                  flux_cfg, dcfg),
                make_student_step(flux, optimizer, flux_cfg, dcfg))
    else:
        step = make_distill_step(flux, teacher_text_fn, student_states_fn,
                                 optimizer, flux_cfg, dcfg)
    return step, state, parts


def build_tiny_distill(batch_size: int = 8, remat: bool = False,
                       split: bool = False, use_8bit_adam: bool = False,
                       slim_handoff: bool = False,
                       trees: Optional[Dict[str, Any]] = None, seed: int = 0,
                       device=None, **distill_changes):
    """-> (step, state, batch, parts). ``step`` is step_fn(state, batch,
    noise), or with split=True the pair (teacher_fn, student_fn) of the
    disaggregated topology (slim_handoff: the teacher hands over only the
    KD stacks); ``use_8bit_adam`` takes ``train/optim8bit.py``'s moments.
    trees: optional flax param trees (numpy leaves) {"flux", "lm", "t5",
    "clip", "proj"}; without them the weights are drawn from a
    torch.Generator seeded with ``seed``. distill_changes replace fields of
    the tiny DistillConfig (e.g. inline_kd, kd_stacks_int8)."""
    dev = resolve_device(device)
    f32 = torch.float32
    flux_cfg = tiny_flux_config(guidance_embeds=True, remat=remat)
    lm_cfg = tiny_qwen2_config()
    t5_cfg = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64,
                      num_layers=1, num_heads=4, dtype=f32)
    clip_cfg = CLIPTextConfig(
        vocab_size=64, hidden_size=flux_cfg.pooled_projection_dim,
        intermediate_size=64, num_hidden_layers=1, num_attention_heads=4,
        max_position_embeddings=16, eos_token_id=63, dtype=f32)
    proj_cfg = ProjConfig(in_channels=lm_cfg.num_layers_with_embedding,
                          input_dim=lm_cfg.hidden_size,
                          output_dim0=flux_cfg.pooled_projection_dim,
                          output_dim1=flux_cfg.joint_attention_dim, dtype=f32)
    dcfg = DistillConfig(latent_height=8, latent_width=8, text_seq_len=12,
                         lr_warmup_steps=1, max_train_steps=100,
                         learning_rate=1e-3, use_8bit_adam=use_8bit_adam,
                         **distill_changes)

    b, s = batch_size, dcfg.text_seq_len
    rng = np.random.default_rng(0)
    batch = {
        "t5_ids": rng.integers(0, 64, (b, s)),
        "t5_mask": np.ones((b, s), bool),
        "clip_ids": rng.integers(0, 63, (b, s)),
        "mllm_ids": rng.integers(0, lm_cfg.vocab_size, (b, s)),
        "mllm_mask": np.ones((b, s), bool),
    }
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    # the tiny T5 is narrower than the DiT's text width: a fixed projection
    widen = torch.as_tensor(rng.standard_normal(
        (t5_cfg.d_model, flux_cfg.joint_attention_dim)).astype(np.float32),
        device=dev) * 0.1

    mods = {"flux": FluxTransformer2D(flux_cfg, dev),
            "lm": Qwen2LM(lm_cfg, dev), "t5": T5Encoder(t5_cfg, dev),
            "clip": CLIPTextEncoder(clip_cfg, dev), "proj": Proj(proj_cfg, dev)}
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, mod in mods.items():
        if trees is not None:
            load_flax(mod, trees[name])
        else:
            random_init_(mod, gen)
    step, state, parts = wire_distill(
        mods["flux"], mods["lm"], mods["t5"], mods["clip"], mods["proj"],
        widen, flux_cfg, dcfg, split=split, slim_handoff=slim_handoff)
    return step, state, batch, parts


def build_random_distill(scale: str = "full", seed: int = 0, device=None,
                         flux: Optional[FluxTransformer2D] = None,
                         lm: Optional[Qwen2LM] = None, dcfg=None):
    """The full-width x2i-internvl2.5-1b phase-1 trainer in bf16, batch 1,
    as the single-card split step: -> ((teacher_fn, student_fn), state,
    batch, parts) (see ``single_chip_distill``).

    Random weights are drawn on the card from one torch.Generator seeded
    with ``seed`` (Dense std 1/sqrt(fan_in), norm scales 1, biases 0). A
    given ``flux`` or ``lm`` is used as it is (its weights frozen in
    place), the DiT set to the trainer's config: remat on, rope outside
    the kernel, fused glue off (``replace_config``; a caller that serves
    with it afterwards sets its own fields back). The batch holds
    REAL_TOKENS token ids, right-padded to the 512 text tokens with the
    mask, for the LM and T5, and 77 CLIP ids with the EOS after them."""
    if scale != "full":
        raise NotImplementedError(f"scale={scale!r}: 'full' only (the tiny "
                                  f"trainer is build_tiny_distill)")
    dev = resolve_device(device)
    spec = MODEL_REGISTRY["x2i-internvl2.5-1b"]
    dcfg = dcfg or DistillConfig(lr_warmup_steps=1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    train = dict(remat=True, rope_in_kernel=False, fused_glue=False)
    if flux is None:
        flux = random_init_(FluxTransformer2D(
            dataclasses.replace(spec.flux, **train), dev), gen)
    else:
        flux.replace_config(**train)
    if lm is None:
        lm = random_init_(Qwen2LM(spec.llm, dev), gen)
    t5_cfg, clip_cfg = T5Config(), CLIPTextConfig()
    t5 = random_init_(T5Encoder(t5_cfg, dev), gen)
    clip = random_init_(CLIPTextEncoder(clip_cfg, dev), gen)
    proj = random_init_(Proj(spec.proj, dev), gen)

    s = dcfg.text_seq_len
    rng = np.random.default_rng(seed)
    mask = np.arange(s)[None] < REAL_TOKENS
    clip_ids = rng.integers(0, clip_cfg.eos_token_id, (1, 77))
    clip_ids[:, REAL_TOKENS] = clip_cfg.eos_token_id
    batch = {
        "t5_ids": np.where(mask, rng.integers(0, t5_cfg.vocab_size, (1, s)),
                           0),
        "t5_mask": mask,
        "clip_ids": clip_ids,
        "mllm_ids": np.where(mask, rng.integers(0, spec.llm.vocab_size,
                                                (1, s)), 0),
        "mllm_mask": mask,
    }
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    step, state, parts = wire_distill(flux, lm, t5, clip, proj, None,
                                      flux.cfg, dcfg, split=True,
                                      slim_handoff=True)
    return step, state, batch, parts


# the trainer's DiT: remat on, rope outside the kernel, no fused glue (the
# glue kernels and K1's rope variant have no backward)
TRAIN_DIT = dict(remat=True, rope_in_kernel=False, fused_glue=False)


def _wire_lightcontrol(flux, vae_encode, conditioning_fn, bank, flux_cfg,
                       ccfg, sched_cfg, frozen):
    for m in frozen:
        m.requires_grad_(False)
    optimizer = make_lightcontrol_optimizer(ccfg)
    state = init_control_state(bank, optimizer)
    step = make_lightcontrol_step(flux, vae_encode, conditioning_fn,
                                  flux_cfg, ccfg, sched_cfg, optimizer)
    parts = {"flux": flux, "bank": bank, "optimizer": optimizer,
             "vae_encode": vae_encode, "conditioning_fn": conditioning_fn,
             "flux_cfg": flux_cfg, "ccfg": ccfg, "sched_cfg": sched_cfg}
    return step, state, parts


def build_tiny_lightcontrol(batch_size: int = 8,
                            trees: Optional[Dict[str, Any]] = None,
                            seed: int = 0, device=None, **ccfg_changes):
    """-> (step, state, batch, parts): the JAX harness's tiny phase-2
    trainer (a 2 + 4-block FLUX with 16 input channels and guidance, a /8
    VAE of 8 channels and 4 latents, 2 tiny branches, 32^2 pixels: 4
    tokens; learning rate 1e-3, no accumulation, shift 3), also the model
    JAX's command line builds; its batch numpy's draws from
    ``default_rng(seed)`` (with seed 0 the JAX harness's, with the
    command line's seed its). trees: optional flax param trees (numpy
    leaves) {"flux", "vae", "bank"}, else weights from a torch.Generator
    seeded with ``seed``. ccfg_changes replace fields of the
    LightControlConfig (e.g. gradient_accumulation_steps)."""
    dev = resolve_device(device)
    f32 = torch.float32
    flux_cfg = tiny_flux_config(guidance_embeds=True, in_channels=16)
    vae_cfg = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                        latent_channels=4, norm_num_groups=4, dtype=f32)
    ctrl_cfg = ControlNeXtConfig(in_channels=(8, 8), out_channels=(8, 16),
                                 groups=(2, 2), time_embed_dim=16,
                                 final_out_channels=flux_cfg.inner_dim,
                                 dtype=f32)
    ccfg = dataclasses.replace(LightControlConfig(
        gradient_accumulation_steps=1, learning_rate=1e-3), **ccfg_changes)

    px, b, s = 32, batch_size, 8
    rng = np.random.default_rng(seed)
    batch = {"style_pixels": rng.standard_normal((b, px, px, 3)),
             "prompt": rng.standard_normal((b, s,
                                            flux_cfg.joint_attention_dim)),
             "pooled": rng.standard_normal((b,
                                            flux_cfg.pooled_projection_dim))}
    batch = {k: torch.as_tensor(v.astype(np.float32), device=dev)
             for k, v in batch.items()}
    flux = FluxTransformer2D(flux_cfg, dev)
    vae = AutoencoderKL(vae_cfg, dev)
    bank = ControlBank(ctrl_cfg, flux_cfg.num_layers, dev)
    if trees is not None:
        load_flax(flux, trees["flux"])
        load_flax(vae, trees["vae"])
        load_flax_bank(bank, trees["bank"])
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        for mod in (flux, vae, bank):
            random_init_(mod, gen)

    def conditioning_fn(bt):
        return bt["pooled"], bt["prompt"]

    step, state, parts = _wire_lightcontrol(
        flux, vae.encode, conditioning_fn, bank, flux_cfg, ccfg,
        SchedulerConfig(shift=3.0), (flux, vae))
    parts["vae"] = vae
    return step, state, batch, parts


def build_random_lightcontrol(scale: str = "full", seed: int = 0,
                              pipe=None, request=None, device=None,
                              ccfg: Optional[LightControlConfig] = None,
                              px: int = 1024):
    """The full-width x2i-internvl2.5-1b phase-2 trainer in bf16, batch 1,
    on ``pipe``'s DiT, VAE, encoder and proj (frozen in place; the DiT set
    to the trainer's config, ``TRAIN_DIT``: a caller that serves with it
    afterwards sets its own fields back): -> (step, state, batch, parts).

    The bank is ``ControlNeXtConfig()`` x 19 (128 / 256 channels, out
    the DiT's width: 3072), in the DiT's dtype, drawn on the card from a torch.Generator seeded with ``seed``
    (conv and Linear std 1/sqrt(fan_in), norm scales 1, biases 0); the
    target image (1, px, px, 3) uniform in [-1, 1) from the same
    generator. The conditioning is ``pipe.encode(request)`` (by default a
    text2image instruction), copied out of inference mode. ``ccfg``:
    LightControlConfig() by default."""
    if scale != "full":
        raise NotImplementedError(f"scale={scale!r}: 'full' only (the tiny "
                                  f"trainer is build_tiny_lightcontrol)")
    if pipe is None:
        raise ValueError("build_random_lightcontrol needs a pipeline (its "
                         "DiT, VAE and encoder)")
    dev = resolve_device(device)
    ccfg = ccfg or LightControlConfig()
    spec = MODEL_REGISTRY["x2i-internvl2.5-1b"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    flux = pipe.flux.replace_config(**TRAIN_DIT)
    bank_cfg = ControlNeXtConfig(final_out_channels=flux.cfg.inner_dim,
                                 dtype=flux.cfg.dtype)
    bank = random_init_(ControlBank(bank_cfg, ccfg.num_controls, dev), gen)
    pixels = torch.rand((1, px, px, 3), generator=gen, device=dev) * 2 - 1
    request = request or {"task": "text2image",
                          "prompt": "make the sky stormy"}

    def conditioning_fn(bt):
        return tuple(t.clone() for t in pipe.encode(bt["request"]))

    frozen = [flux, pipe.vae, pipe.proj]
    frozen += [m for m in getattr(pipe.encoder_fn, "ctx", {}).values()
               if isinstance(m, torch.nn.Module)]
    step, state, parts = _wire_lightcontrol(
        flux, pipe.vae.encode, conditioning_fn, bank, flux.cfg, ccfg,
        spec.scheduler, frozen)
    return step, state, {"style_pixels": pixels, "request": request}, parts
