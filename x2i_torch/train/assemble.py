"""The phase-1 trainer assembled from checkpoint directories, the
counterpart of ``x2i_tpu/train/assemble.py``.

It wires what the reference's train_{minicpm,qwenvl,internvl}.py main()
does: the frozen teachers (T5-XXL's encoder, CLIP-L's text tower), the
frozen MLLM and FLUX, the trainable proj, the tokenizers and the
datamodule, into the port's one-card split step (``single_chip_distill``:
the teacher hands over its KD stacks, the student regenerates the noise
latents from the step's seed), which ``train/runner.py::TrainLoop`` drives
with the datamodule's loader.

Differences from JAX's, whose first call raises (it imports
``internvl_params_from_hf`` from a module that does not define it): the
T5 and CLIP configs are read from their directories' config.json
(``T5Config()`` and ``CLIPTextConfig()`` where absent; JAX hard-codes
these), as is the DiT's (JAX takes the registry's); the tokenizers may be
passed in.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from x2i_torch.convert.hf_config import (flux_config_from_dir,
                                         proj_config_from_sd)
from x2i_torch.convert.load import (load_clip_text, load_mllm,
                                    load_safetensors_dir, load_t5,
                                    load_tokenizer, load_torch_bin)
from x2i_torch.convert.torch_models import fill_module, flux_plan, proj_plan
from x2i_torch.core.config import MODEL_REGISTRY, DistillConfig
from x2i_torch.data.datamodule import (DistillDataConfig, DistillDataModule,
                                       family_chat_template, hf_tokenize)
from x2i_torch.data.loader import StreamCopy
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2_5_vl import encode_text
from x2i_torch.params import random_init_
from x2i_torch.pipeline import resolve_device
from x2i_torch.train.harness import TRAIN_DIT, wire_distill


def text_positions(mask: torch.Tensor) -> torch.Tensor:
    """Qwen2.5-VL's 3-D positions of a text-only batch (JAX's): each row's
    count of valid tokens before each position, (3, B, S)."""
    pos = (mask.long().cumsum(-1) - 1).clamp_min(0)
    return pos[None].expand(3, *pos.shape)


def student_states_fn(model: str, vl_cfg, encoder) -> Callable:
    """batch -> the MLLM's hidden-state stack (B, L+1, S, H): the family's
    text prefill (the phase-1 corpus is captions)."""
    if "qwenvl" in model:
        def states(b):
            return encode_text(encoder.language_model, vl_cfg,
                               b["mllm_ids"], b["mllm_mask"],
                               text_positions(b["mllm_mask"]))
        return states
    return lambda b: encoder(b["mllm_ids"], b["mllm_mask"])


def assemble_distill(model: str, flux_path: str, mllm_path: str,
                     t5_path: str, clip_path: str, urls,
                     dcfg: Optional[DistillConfig] = None,
                     proj_ckpt: Optional[str] = None, device=None,
                     tokenizers: Optional[Sequence[Any]] = None,
                     dtype: torch.dtype = torch.bfloat16):
    """-> (step_fn, state, parts, train_loader) for ``TrainLoop``.

    Paths follow the reference launchers: a FLUX diffusers directory (its
    ``transformer/``: teacher and student share the frozen DiT, in the
    trainer's config ``TRAIN_DIT``), the HF MLLM directory of a registry
    model's family (InternVL2.5, Qwen2.5-VL with the 3-D text positions,
    MiniCPM-o: the text prefill is the student's states), a T5-XXL encoder
    directory and a CLIP directory (its text tower). The proj comes from
    ``proj_ckpt`` (the reference's .bin, DDP ``module.`` prefixes
    stripped) or is drawn from a torch.Generator seeded with 0 (JAX draws
    it from ``jax.random.key(0)``).
    ``dtype`` is that of every frozen module and of the proj. JAX's
    ``assemble_distill`` has no such argument: its configs fix bf16, the
    default here, which a run on the card takes. float32 is there to hold
    the assembled step to a reference step at f32 precision (a step in
    bf16 rounds too coarsely for that check; the CPU tests use it).

    ``step_fn(state, batch, noise) -> (state, metrics)`` runs the teacher
    then the student; ``train_loader(device_put=None, timeout=600.0)`` is
    the ``DistillDataModule`` loader over ``urls`` with
    ``family_chat_template`` and JAX's padding (the MLLM and T5 ids to
    ``dcfg.text_seq_len``, CLIP's to 77), its batches copied to the
    device by ``StreamCopy`` unless ``device_put`` says otherwise.
    ``tokenizers``: (mllm, t5, clip) HF-style tokenizers (called with
    ``padding="max_length"``; the MLLM's also with
    ``apply_chat_template`` and ``convert_tokens_to_ids``); None loads
    each from its directory through ``transformers``. ``parts`` holds
    the modules, the teacher and student halves, the datamodule and
    ``load_report``: per module (flux, mllm, t5, clip, proj) the tensors
    and bytes read and the keys left unread."""
    dev = resolve_device(device)
    dcfg = dcfg or DistillConfig()
    spec = MODEL_REGISTRY[model]
    if tokenizers is None:
        tokenizers = (load_tokenizer(mllm_path, trust_remote_code=True,
                                     use_fast=False),
                      load_tokenizer(t5_path), load_tokenizer(clip_path))
    mllm_tok, t5_tok, clip_tok = tokenizers
    report: Dict[str, Any] = {}

    flux_cfg = replace(flux_config_from_dir(flux_path, base=spec.flux)
                       or spec.flux, dtype=dtype, **TRAIN_DIT)
    flux = FluxTransformer2D(flux_cfg, "meta").to_empty(device=dev)
    report["flux"] = fill_module(
        flux, load_safetensors_dir(os.path.join(flux_path, "transformer")),
        flux_plan(flux_cfg))
    vl_cfg, encoder, report["mllm"] = load_mllm(model, mllm_path, mllm_tok,
                                                dev, dtype)
    t5, report["t5"] = load_t5(t5_path, dev, dtype)
    clip, report["clip"] = load_clip_text(clip_path, dev, dtype)

    llm = vl_cfg.llm
    proj_cfg = replace(spec.proj, in_channels=llm.num_layers_with_embedding,
                       input_dim=llm.hidden_size,
                       output_dim0=flux_cfg.pooled_projection_dim,
                       output_dim1=flux_cfg.joint_attention_dim, dtype=dtype)
    if proj_ckpt:
        sd = {k.removeprefix("module."): v
              for k, v in load_torch_bin(proj_ckpt).items()}
        proj_cfg = replace(proj_config_from_sd(sd, base=proj_cfg),
                           dtype=dtype)
        proj = Proj(proj_cfg, "meta").to_empty(device=dev)
        report["proj"] = fill_module(proj, sd.items(), proj_plan(proj_cfg))
    else:
        proj = random_init_(Proj(proj_cfg, dev),
                            torch.Generator(device=dev).manual_seed(0))

    (teacher_fn, student_fn), state, parts = wire_distill(
        flux, encoder, t5, clip, proj, None, flux_cfg, dcfg, split=True,
        slim_handoff=True,
        student_states_fn=student_states_fn(model, vl_cfg, encoder))

    def step_fn(state, batch, noise):
        return student_fn(state, batch, teacher_fn(batch, noise), noise)

    dm = DistillDataModule(
        DistillDataConfig(urls=urls, batch_size=dcfg.train_batch_size,
                          text_seq_len=dcfg.text_seq_len),
        mllm_tokenize=hf_tokenize(mllm_tok, dcfg.text_seq_len),
        t5_tokenize=hf_tokenize(t5_tok, dcfg.text_seq_len),
        clip_tokenize=hf_tokenize(clip_tok, 77, with_mask=False),
        chat_template=family_chat_template(model, mllm_tok))

    def train_loader(device_put: Optional[Callable] = None,
                     timeout: float = 600.0):
        return dm.train_loader(device_put or StreamCopy(dev), timeout)

    parts.update(encoder=encoder, vl_cfg=vl_cfg, teacher_fn=teacher_fn,
                 student_fn=student_fn, datamodule=dm, load_report=report)
    return step_fn, state, parts, train_loader
