"""Model configs read from checkpoint directories, the counterpart of
``x2i_tpu/convert/hf_config.py``, with the slice scale of MiniCPM-o's
``preprocessor_config.json`` that the JAX loader reads.

The released checkpoints carry their architecture in their own config
files: the diffusers ``transformer/config.json``, ``vae/config.json``
and ``scheduler/scheduler_config.json`` of a FLUX directory, and the HF
``config.json`` of an MLLM directory (``llm_config``, ``vision_config``
and ``downsample_ratio`` for InternVL, a ``text_config`` or flat text
fields and a ``vision_config`` for Qwen2.5-VL, flat LM fields beside a
``vision_config``, an ``audio_config`` and ``query_num`` for MiniCPM-o).
Each of these readers returns None when its file is absent, and the
registry entry is then the fallback. The teachers' and the scorer's
readers (``t5_config_from_dir``, ``clip_configs_from_dir``) return the
defaults (T5-XXL, CLIP-L) for a directory without a ``config.json``. The
proj checkpoint is a bare state dict: ``proj_config_from_sd`` reads its
architecture from the shapes.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from typing import Any, Dict, Mapping, Optional, Tuple

from x2i_torch.core.config import (CLIPTextConfig, CLIPVisionConfig,
                                   FluxConfig, InternVLConfig,
                                   MiniCPMOConfig, ProjConfig, Qwen2Config,
                                   SchedulerConfig, SiglipVisionConfig,
                                   T5Config, VAEConfig, WhisperConfig)
from x2i_torch.models.qwen2_5_vl import Qwen2_5_VLConfig, QwenVisionConfig


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _fields(d: Mapping[str, Any], names) -> Dict[str, Any]:
    """The config fields ``names`` that ``d`` sets, as replace()
    arguments (lists as tuples)."""
    return {n: tuple(d[n]) if isinstance(d[n], list) else d[n]
            for n in names if n in d}


def flux_config_from_dir(flux_path: str,
                         base: Optional[FluxConfig] = None
                         ) -> Optional[FluxConfig]:
    """diffusers FluxTransformer2DModel ``transformer/config.json``."""
    d = _read_json(os.path.join(flux_path, "transformer", "config.json"))
    if d is None:
        return None
    return replace(base or FluxConfig(), **_fields(d, (
        "patch_size", "in_channels", "num_layers", "num_single_layers",
        "attention_head_dim", "num_attention_heads", "joint_attention_dim",
        "pooled_projection_dim", "guidance_embeds", "axes_dims_rope")))


def vae_config_from_dir(flux_path: str) -> Optional[VAEConfig]:
    """diffusers AutoencoderKL ``vae/config.json``."""
    d = _read_json(os.path.join(flux_path, "vae", "config.json"))
    if d is None:
        return None
    base = VAEConfig()
    return replace(base, **_fields(d, (
        "in_channels", "out_channels", "latent_channels", "block_out_channels",
        "layers_per_block", "norm_num_groups", "scaling_factor")),
        shift_factor=d.get("shift_factor", base.shift_factor) or 0.0,
        use_mid_attention=d.get("mid_block_add_attention",
                                base.use_mid_attention))


def scheduler_config_from_dir(flux_path: str
                              ) -> Optional[SchedulerConfig]:
    """diffusers FlowMatchEulerDiscreteScheduler
    ``scheduler/scheduler_config.json``."""
    d = _read_json(os.path.join(flux_path, "scheduler",
                                "scheduler_config.json"))
    if d is None:
        return None
    base = SchedulerConfig()
    return replace(base, **_fields(d, (
        "num_train_timesteps", "shift", "use_dynamic_shifting",
        "base_shift", "max_shift", "base_image_seq_len",
        "max_image_seq_len")))


def _qwen2_from_dict(d: Mapping[str, Any],
                     base: Optional[Qwen2Config] = None) -> Qwen2Config:
    base = base or Qwen2Config()
    heads = d.get("num_attention_heads", base.num_attention_heads)
    hidden = d.get("hidden_size", base.hidden_size)
    return replace(base, **_fields(d, (
        "vocab_size", "intermediate_size", "num_hidden_layers",
        "num_key_value_heads", "max_position_embeddings", "rope_theta",
        "rms_norm_eps", "tie_word_embeddings")),
        hidden_size=hidden, num_attention_heads=heads,
        head_dim=d.get("head_dim") or hidden // heads)


def qwenvl_config_from_dir(mllm_path: str, base_llm: Qwen2Config
                           ) -> Optional[Qwen2_5_VLConfig]:
    """HF Qwen2.5-VL ``config.json``: the LM from the flat text fields
    (the released Instruct layout) or from ``text_config`` (newer
    transformers), the tower from ``vision_config`` (its output at the
    LM's width where the file does not say), ``mrope_section`` from
    ``rope_scaling``, and the vision token ids."""
    d = _read_json(os.path.join(mllm_path, "config.json"))
    if d is None:
        return None
    text = d.get("text_config", d)
    llm = _qwen2_from_dict(text, base_llm)
    v = d.get("vision_config") or {}
    vision = replace(QwenVisionConfig(out_hidden_size=llm.hidden_size),
                     **_fields(v, (
                         "depth", "hidden_size", "intermediate_size",
                         "num_heads", "in_channels", "patch_size",
                         "spatial_merge_size", "temporal_patch_size",
                         "window_size", "out_hidden_size",
                         "fullatt_block_indexes")))
    rope_scaling = text.get("rope_scaling") or d.get("rope_scaling") or {}
    full = Qwen2_5_VLConfig(vision=vision, llm=llm)
    return replace(
        full,
        mrope_section=tuple(rope_scaling.get("mrope_section",
                                             full.mrope_section)),
        **_fields(d, ("image_token_id", "video_token_id",
                            "vision_start_token_id")))


def internvl_llm_config_from_dir(mllm_path: str, base_llm: Qwen2Config
                                 ) -> Optional[Qwen2Config]:
    """HF InternVLChatModel ``config.json``: its ``llm_config`` (the LM
    part of the JAX ``internvl_config_from_dir``)."""
    d = _read_json(os.path.join(mllm_path, "config.json"))
    if d is None:
        return None
    return _qwen2_from_dict(d.get("llm_config") or {}, base_llm)


def internvl_config_from_dir(mllm_path: str, base: InternVLConfig
                             ) -> Optional[InternVLConfig]:
    """HF InternVLChatModel ``config.json``: ``llm_config``,
    ``vision_config`` (``force_image_size`` over its ``image_size``,
    ``norm_type``), ``downsample_ratio`` and ``ps_version``, and the
    tokens per tile they give."""
    d = _read_json(os.path.join(mllm_path, "config.json"))
    if d is None:
        return None
    llm = _qwen2_from_dict(d.get("llm_config") or {}, base.llm)
    v = d.get("vision_config") or {}
    vb = base.vision
    vision = replace(
        vb, **_fields(v, ("hidden_size", "intermediate_size",
                          "num_hidden_layers", "num_attention_heads",
                          "patch_size", "qkv_bias", "qk_normalization")),
        image_size=d.get("force_image_size",
                         v.get("image_size", vb.image_size)),
        use_rms_norm=(v.get("norm_type", "rms_norm" if vb.use_rms_norm
                            else "layer_norm") == "rms_norm"))
    downsample = d.get("downsample_ratio", base.downsample_ratio)
    num_image_token = int((vision.image_size // vision.patch_size) ** 2
                          * downsample ** 2)
    return replace(base, llm=llm, vision=vision,
                   downsample_ratio=downsample,
                   ps_version=d.get("ps_version", base.ps_version),
                   num_image_token=num_image_token)


def minicpmo_config_from_dir(mllm_path: str, base_llm: Qwen2Config
                             ) -> Optional[MiniCPMOConfig]:
    """HF MiniCPM-o ``config.json``: the flat Qwen2 fields, SigLIP's from
    ``vision_config``, Whisper's from ``audio_config``, ``query_num`` and
    ``audio_pool_step``; the resampler's heads are the LM's width // 128
    (the reference's rule)."""
    d = _read_json(os.path.join(mllm_path, "config.json"))
    if d is None:
        return None
    llm = _qwen2_from_dict(d, base_llm)
    vision = replace(SiglipVisionConfig(), **_fields(
        d.get("vision_config") or {}, (
            "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "image_size", "patch_size")))
    audio = replace(WhisperConfig(), **_fields(
        d.get("audio_config") or {}, (
            "num_mel_bins", "d_model", "encoder_layers",
            "encoder_attention_heads", "encoder_ffn_dim",
            "max_source_positions")))
    return MiniCPMOConfig(vision=vision, audio=audio, llm=llm,
                          query_num=d.get("query_num", 64),
                          audio_pool_step=d.get("audio_pool_step", 2),
                          resampler_heads=max(1, llm.hidden_size // 128))


def minicpm_scale_resolution(mllm_path: str) -> int:
    """The slices' scale of a MiniCPM-o directory: its
    ``preprocessor_config.json``'s ``slice_config.scale_resolution`` (or
    a top-level ``scale_resolution``), 448 without the file."""
    d = _read_json(os.path.join(mllm_path, "preprocessor_config.json"))
    if d is None:
        return 448
    return (d.get("slice_config") or d).get("scale_resolution", 448)


def t5_config_from_dir(t5_path: str) -> T5Config:
    """HF T5EncoderModel ``config.json`` (``layer_norm_epsilon`` ->
    layer_norm_eps); ``T5Config()`` (T5-XXL) without one."""
    d = _read_json(os.path.join(t5_path, "config.json")) or {}
    fields = _fields(d, (
        "vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads",
        "relative_attention_num_buckets",
        "relative_attention_max_distance"))
    if "layer_norm_epsilon" in d:
        fields["layer_norm_eps"] = d["layer_norm_epsilon"]
    return replace(T5Config(), **fields)


# HF's legacy CLIP text configs (openai/clip-vit-*) say eos_token_id 2;
# transformers then pools at the largest id, the end token (vocab - 1)
_LEGACY_EOS = 2


def clip_configs_from_dir(clip_path: str, dtype=None
                          ) -> Tuple[CLIPTextConfig, CLIPVisionConfig]:
    """(text, vision) configs of an HF CLIP directory: a ``CLIPModel``'s
    ``config.json`` (``text_config``, ``vision_config``,
    ``projection_dim``) or a ``CLIPTextModel``'s flat one; the fields JAX's
    ``build_clip_scorer`` reads, each default where absent (CLIP-L's, as
    without a file). The legacy ``eos_token_id`` 2 becomes the vocabulary's
    last id, where transformers pools. ``dtype``: both towers' (the
    configs' default, bf16, when None)."""
    d = _read_json(os.path.join(clip_path, "config.json")) or {}
    tc = d.get("text_config") or (
        d if d.get("model_type") == "clip_text_model" else {})
    vc = d.get("vision_config") or {}
    text = replace(CLIPTextConfig(), **_fields(tc, (
        "vocab_size", "hidden_size", "intermediate_size",
        "num_hidden_layers", "num_attention_heads",
        "max_position_embeddings", "eos_token_id")))
    if text.eos_token_id == _LEGACY_EOS:
        text = replace(text, eos_token_id=text.vocab_size - 1)
    vision = replace(CLIPVisionConfig(), **_fields(vc, (
        "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "image_size", "patch_size")),
        **_fields(d, ("projection_dim",)))
    if dtype is not None:
        text, vision = replace(text, dtype=dtype), replace(vision,
                                                           dtype=dtype)
    return text, vision


def proj_config_from_sd(sd: Mapping[str, Any],
                        base: Optional[ProjConfig] = None) -> ProjConfig:
    """The proj's architecture from its state dict's shapes ('module.'
    prefixes stripped): ``cha_scale`` (1, C, 1, 1) -> use_scale and C;
    ``conv.weight`` (1, C, k, k) -> use_cnn, C and k; the LayerNorm's
    width, the projector's and the pooled head's; ``t5stack.*`` ->
    use_t5."""
    base = base or ProjConfig()
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    use_scale = "cha_scale" in sd
    use_cnn = "conv.weight" in sd
    in_channels, kernel = base.in_channels, base.kernel_size
    if use_scale:
        in_channels = int(sd["cha_scale"].shape[1])
    elif use_cnn:
        in_channels = int(sd["conv.weight"].shape[1])
        kernel = int(sd["conv.weight"].shape[2])
    return replace(
        base,
        in_channels=in_channels, kernel_size=kernel,
        input_dim=int(sd["mlp.layernorm.weight"].shape[0]),
        output_dim1=int(sd["mlp.projector.0.weight"].shape[0]),
        output_dim0=int(sd["mlp.fc.1.weight"].shape[0]),
        use_t5=any(k.startswith("t5stack.") for k in sd),
        use_scale=use_scale, use_cnn=use_cnn)
