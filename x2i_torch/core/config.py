"""Typed configuration for the PyTorch port.

Own copies of the dataclasses of ``x2i_tpu/core/config.py`` (and of the
T5 and CLIP configs of ``x2i_tpu/models/t5.py`` and ``clip.py``) that the
serving paths, the two trainers (phase-1 distillation, phase-2
LightControl), the CLIP scorer and the parallel layer read, with torch
dtypes. Only the fields these paths use are here: ``MeshConfig``,
``FluxConfig.ring_sequence`` (ring attention over the model's tensor
axis, ``ops/ring_attention.py``) and ``FluxConfig.shard_activations`` /
``shard_sequence`` (JAX's XLA placement constraints: here the DiT's heads
and FFN, or its residual streams' tokens, split over the model's tensor
axis with the axis's own collectives, ``parallel/tensor.py`` and
``FluxTransformer2D.set_tensor_axis``), but no ``single_scan_chunks`` and
no ``remat="stack"`` (XLA scan memory devices, not ported).

``dtype`` is both the parameter storage type and the compute type (the
JAX package keeps them as two fields; every shipped config sets them
equal).

``attention_impl`` replaces the JAX ``use_pallas_attention`` flag:
"auto" takes the hand-written kernel on a CUDA tensor when the shapes
allow it and the plain attention on the CPU (the JAX rule: Pallas off the
CPU), "kernel" always calls the kernel's wrapper (on a CPU tensor that is
the kernel's plain version, the counterpart of Pallas interpret mode),
"plain" always takes the plain attention.

``quantized`` is the JAX field (False | "w8" | "w8a8" | "w4" | "w4a8").
With ``fused_glue`` and "w8a8" or "w4a8" the DiT's glue is the
quantizing kernels K6/K7/K8 (the JAX ``_use_fused_glue`` mode "quant"),
otherwise ``ln_mod`` (mode "ln", the weight-only modes w8 and w4 among
them). ``quant_impl`` picks the route of the quantization and the
products (the int8 and w4a8 GEMMs, the w4 dequantize kernel): "auto"
takes the kernels on a CUDA tensor and their plain versions on the CPU,
"plain" always the plain versions (the wrappers have no CPU route of
their own for a "kernel" value to force, as ``attention_impl`` has).
``Qwen2Config`` has the same two fields: its dense layers (the untied
``lm_head`` among them) become ``QuantLinear``; the embedding table, the
norms and a tied head stay in ``dtype``. ``quantize_module_`` reads
``quant_impl`` from every config that has ``quantized``.

``MODEL_REGISTRY`` and ``PROJ_REGISTRY`` hold the JAX package's six
models and five projs, field for field. A ``ModelSpec`` carries the LM
as ``llm`` and, for the two InternVL2.5 entries, the JAX entry's whole
``InternVLConfig`` (InternViT, pixel shuffle, ``<IMG_CONTEXT>``) as
``internvl``, and for the two MiniCPM-o entries the whole
``MiniCPMOConfig`` (SigLIP, the resampler, Whisper) as ``minicpmo``,
whose ``llm`` is the same LM. The Qwen2.5-VL entries carry
no vision config, as in JAX: the loader takes the released tower's
(``models/qwen2_5_vl.py::QwenVisionConfig``) at the LM's width.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch

QUANT_MODES = ("w8", "w8a8", "w4", "w4a8")
# the modes whose activations are quantized per token (the "quant" glue)
ACT_QUANT_MODES = ("w8a8", "w4a8")


def with_dtype(cfg, dtype):
    """``cfg`` with ``dtype`` in its own ``dtype`` field and in those of
    the configs it nests (an encoder's vision and LM configs)."""
    changes = {f.name: (dtype if f.name == "dtype" else
                        with_dtype(getattr(cfg, f.name), dtype))
               for f in fields(cfg)
               if f.name == "dtype" or is_dataclass(getattr(cfg, f.name))}
    return replace(cfg, **changes)


def quant_mode(quantized) -> Optional[str]:
    """False | "w8" | "w8a8" | "w4" | "w4a8" -> None or the mode; raises
    on any other value."""
    if not quantized:
        return None
    if quantized not in QUANT_MODES:
        raise NotImplementedError(f"quantized={quantized!r}: one of "
                                  f"{QUANT_MODES}")
    return quantized


@dataclass(frozen=True)
class FluxConfig:
    """FLUX-class rectified-flow DiT (FLUX.1-schnell defaults): 19 double
    and 38 single blocks, 24 heads x 128, 3-axis RoPE."""

    patch_size: int = 1
    in_channels: int = 64            # packed latents: 16 ch x 2x2 patch
    num_layers: int = 19             # double-stream (MMDiT) blocks
    num_single_layers: int = 38      # single-stream blocks
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096  # text conditioning width
    pooled_projection_dim: int = 768
    guidance_embeds: bool = False    # True for FLUX.1-dev, False for schnell
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    mlp_ratio: float = 4.0
    time_embed_dim: int = 256
    qk_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"     # "auto" | "kernel" | "plain"
    fused_glue: bool = False         # glue kernels for LayerNorm+modulate
                                     # (and gelu and the activation
                                     # quantization in w8a8 and w4a8) and
                                     # the qk RMSNorm folded into the
                                     # attention kernel (inference only)
    quantized: Any = False           # False | "w8" | "w8a8" | "w4" |
                                     # "w4a8"
    quant_impl: str = "auto"         # "auto" | "plain"
    remat: bool = False              # True: recompute each block in the
                                     # backward (torch.utils.checkpoint,
                                     # non-reentrant)
    rope_in_kernel: bool = True      # rotate q/k inside the attention
                                     # kernel; False rotates them before
                                     # (the trainer's setting)
    ring_sequence: bool = False      # ring attention over the model's
                                     # tensor axis (``ring_axis``): the
                                     # qk norm and the rope outside the
                                     # kernels, the glue unfused
    shard_activations: bool = False  # tensor-parallel: each member of
                                     # the model's tensor axis runs its
                                     # block of heads and of the FFN, the
                                     # row-split outputs summed over it
    shard_sequence: bool = False     # sequence-parallel: the residual
                                     # streams' tokens split over the
                                     # tensor axis between blocks, K and V
                                     # gathered for the joint attention
    rope_layout: str = "half"        # "half": q/k channels permuted per
                                     # head (``ops/rope.py::
                                     # half_layout_perm``, as the
                                     # converters leave them), the rotation
                                     # and the qk norm inside the kernel;
                                     # "interleaved": diffusers' pairs as
                                     # stored, the qk norm and the rotation
                                     # before a kernel without rope

    def __post_init__(self):
        quant_mode(self.quantized)
        if self.rope_layout not in ("half", "interleaved"):
            raise ValueError(f"rope_layout={self.rope_layout!r}: 'half' or "
                             f"'interleaved'")
        if self.quant_impl not in ("auto", "plain"):
            raise ValueError(f"quant_impl={self.quant_impl!r}")
        if self.remat not in (False, True):
            raise NotImplementedError(f"remat={self.remat!r}: only False "
                                      f"and True are ported")

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def sharded(self) -> bool:
        """Whether a block's work is split over the tensor axis
        (``shard_activations`` or ``shard_sequence``)."""
        return self.shard_activations or self.shard_sequence

    @property
    def glue(self):
        """The fused glue mode: None (unfused: also under
        ``ring_sequence``, ``shard_activations`` or ``shard_sequence``, as
        JAX's ``_use_fused_glue``), "ln" or "quant"."""
        if not self.fused_glue or self.sharded or self.ring_sequence:
            return None
        return "quant" if self.quantized in ACT_QUANT_MODES else "ln"


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh's axes (``core/mesh.py``): data (the batch), fsdp
    (parameter and optimizer-state shards, ZeRO's) and tensor (heads, or
    the ring's sequence shards). -1 takes the devices the other axes
    leave."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    axis_names: Tuple[str, ...] = ("data", "fsdp", "tensor")


@dataclass(frozen=True)
class ProjConfig:
    """Alignment network (Proj7Exp + MLP3). in_channels = MLLM hidden-state
    layer count + 1 (embedding layer)."""

    in_channels: int = 25
    kernel_size: int = 5
    input_dim: int = 896
    output_dim0: int = 768            # pooled (CLIP-replacement) width
    output_dim1: int = 4096           # sequence (T5-replacement) width
    norm_eps: float = 1e-6
    use_scale: bool = False
    use_cnn: bool = True
    num_layers: int = 2               # the T5 refiner's depth, heads and
    num_heads: int = 12               # head size
    head_dim: int = 64
    use_t5: bool = False              # T5-style refiner stack over each
                                      # channel (off in shipped configs)
    dtype: Any = torch.bfloat16


@dataclass(frozen=True)
class VAEConfig:
    """FLUX AutoencoderKL (diffusers config of black-forest-labs/FLUX.1-*)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    use_mid_attention: bool = True
    dtype: Any = torch.bfloat16


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2-family causal LM. Defaults = Qwen2.5-0.5B-Instruct, the LM
    inside InternVL2.5-1B (hidden 896, 24 layers -> 25 hidden states)."""

    vocab_size: int = 151674
    hidden_size: int = 896
    intermediate_size: int = 4864
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    head_dim: int = 64
    max_position_embeddings: int = 32768
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True  # False: a separate lm_head
    attention_bias: bool = True
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"
    quantized: Any = False           # False | a mode of QUANT_MODES
    quant_impl: str = "auto"         # "auto" | "plain"

    def __post_init__(self):
        quant_mode(self.quantized)
        if self.quant_impl not in ("auto", "plain"):
            raise ValueError(f"quant_impl={self.quant_impl!r}")

    @property
    def num_layers_with_embedding(self) -> int:
        return self.num_hidden_layers + 1


@dataclass(frozen=True)
class InternViTConfig:
    """InternViT-300M-448px: 24 LayerNorm blocks of width 1024, 16 heads
    of 64, MLP 4096, 14-pixel patches of 448-pixel tiles, learnable
    residual scales ls1/ls2. ``use_rms_norm`` is the JAX field; the
    blocks are LayerNorm blocks either way, as in JAX."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    qk_normalization: bool = False
    use_rms_norm: bool = False
    initializer_factor: float = 0.1  # the initial ls1/ls2
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"


@dataclass(frozen=True)
class InternVLConfig:
    """The InternVL2.5 chat model as the encoder: InternViT, the
    pixel-shuffle mlp1 and the Qwen2 LM, ``num_image_token``
    ``<IMG_CONTEXT>`` tokens per tile ((448/14)^2 * 0.5^2)."""

    vision: InternViTConfig = field(default_factory=InternViTConfig)
    llm: Qwen2Config = field(default_factory=Qwen2Config)
    downsample_ratio: float = 0.5
    ps_version: str = "v2"
    img_context_token_id: int = 151667
    num_image_token: int = 256
    template: str = "internvl2_5"
    dtype: Any = torch.bfloat16


@dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP-so400m with NaViT variable resolution (MiniCPM-o's ``vpm``):
    27 pre-LN blocks of width 1152, 16 heads of 72, 14-pixel patches over
    a 70 x 70 position table; MiniCPM drops the last block
    (``drop_last_layer``), so 26 run."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 980
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    drop_last_layer: bool = True
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def effective_layers(self) -> int:
        return self.num_hidden_layers - (1 if self.drop_last_layer else 0)


@dataclass(frozen=True)
class WhisperConfig:
    """The Whisper-medium encoder (MiniCPM-o's ``apm``): 24 pre-LN blocks
    of width 1024, 16 heads of 64, 80 mel bins, 1500 positions."""

    num_mel_bins: int = 80
    d_model: int = 1024
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    max_source_positions: int = 1500
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"


@dataclass(frozen=True)
class ResamplerConfig:
    """The perceiver resampler: ``num_queries`` learned queries of the
    LM's width cross-attend the ViT's patches (``kv_dim`` wide)."""

    num_queries: int = 64
    embed_dim: int = 3584            # the LM's width (MiniCPM: Qwen2-7B)
    num_heads: int = 28
    kv_dim: int = 1152               # SigLIP's width
    layer_norm_eps: float = 1e-6
    max_size: int = 70
    dtype: Any = torch.bfloat16
    attention_impl: str = "auto"


@dataclass(frozen=True)
class MiniCPMOConfig:
    """MiniCPM-o-2.6's omni encoder: SigLIP, the resampler (``query_num``
    queries a slice, ``resampler_heads`` heads), Whisper with its
    projector (average pool of ``audio_pool_step``) and the Qwen2 LM."""

    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    audio: WhisperConfig = field(default_factory=WhisperConfig)
    llm: Qwen2Config = field(default_factory=lambda: _minicpm_llm())
    query_num: int = 64
    audio_pool_step: int = 2
    resampler_heads: int = 28

    def resampler_config(self) -> ResamplerConfig:
        return ResamplerConfig(num_queries=self.query_num,
                               embed_dim=self.llm.hidden_size,
                               num_heads=self.resampler_heads,
                               kv_dim=self.vision.hidden_size,
                               dtype=self.llm.dtype,
                               attention_impl=self.llm.attention_impl)


@dataclass(frozen=True)
class SchedulerConfig:
    """Flow-match Euler discrete scheduler (diffusers semantics)."""

    num_train_timesteps: int = 1000
    shift: float = 1.0               # 1.0 schnell, 3.0 dev
    use_dynamic_shifting: bool = False
    base_shift: float = 0.5
    max_shift: float = 1.16
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096


@dataclass(frozen=True)
class GenerationConfig:
    """Sampling operating point."""

    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 4
    guidance_scale: float = 3.5      # dev models' baked guidance embed
    seed: int = 0
    vae_tile_px: int = 1536          # tiled VAE decode above this size


@dataclass(frozen=True)
class DistillConfig:
    """Phase-1 attention-distillation operating point (the JAX
    ``DistillConfig``)."""

    learning_rate: float = 1e-4
    lr_scheduler: str = "cosine"
    lr_warmup_steps: int = 100
    max_train_steps: int = 100_000
    train_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    use_8bit_adam: bool = False
    kd_stacks_int8: bool = False     # per-token int8 teacher KD stacks
    inline_kd: bool = False          # KD terms computed inside each student
                                     # block (scalars leave the blocks)
    kd_temperature: float = 3.0
    latent_height: int = 128         # 128x128 latent grid = 4096 img tokens
    latent_width: int = 128
    text_seq_len: int = 512
    checkpointing_steps: int = 1000
    checkpoints_total_limit: Optional[int] = 5
    seed: int = 2024
    remat: bool = True


@dataclass(frozen=True)
class LightControlConfig:
    """Phase-2 ControlNeXt finetune (the JAX ``LightControlConfig``).
    ``control_bank_impl``: "scan" runs the branches one after another,
    each under ``torch.utils.checkpoint`` when gradients are taken (the
    peak holds one branch's activations); "vmap" runs the same loop
    without it. ``max_train_steps``, ``train_batch_size``,
    ``weighting_scheme``, ``checkpointing_steps`` and ``seed`` are the
    JAX config's run settings: no step reads them, as in JAX (the
    command line takes its own flags)."""

    learning_rate: float = 1e-5
    max_train_steps: int = 2_000_000
    train_batch_size: int = 1
    gradient_accumulation_steps: int = 8
    max_grad_norm: float = 1.0
    num_controls: int = 19           # one ControlNeXt per double block
    control_bank_impl: str = "scan"
    use_8bit_adam: bool = False      # train/optim8bit.py's moments
    logit_mean: float = 0.0          # the timestep's logit-normal density
    logit_std: float = 1.0
    weighting_scheme: str = "logit_normal"
    checkpointing_steps: int = 1000
    seed: int = 42


@dataclass(frozen=True)
class ControlNeXtConfig:
    """One ControlNeXt branch (the JAX ``ControlNeXtConfig``)."""

    in_channels: Tuple[int, ...] = (128, 128)
    out_channels: Tuple[int, ...] = (128, 256)
    groups: Tuple[int, ...] = (4, 8)
    time_embed_dim: int = 256
    final_out_channels: int = 3072
    dtype: Any = torch.bfloat16


@dataclass(frozen=True)
class T5Config:
    """T5 v1.1 encoder (defaults: T5-XXL, the teacher text encoder)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower (defaults: openai/clip-vit-large-patch14, the pooled
    teacher)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    dtype: Any = torch.bfloat16


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT (defaults: openai/clip-vit-large-patch14's vision tower, the
    CLIP-T / CLIP-FID scorer's)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    dtype: Any = torch.bfloat16


def _qwen2_5_vl_3b_llm() -> Qwen2Config:
    return Qwen2Config(
        vocab_size=151936, hidden_size=2048, intermediate_size=11008,
        num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=2,
        head_dim=128, rope_theta=1000000.0)


def _qwen2_5_vl_7b_llm() -> Qwen2Config:
    return Qwen2Config(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        head_dim=128, rope_theta=1000000.0)


def _internvl_4b_llm() -> Qwen2Config:
    # Qwen2.5-3B-Instruct inside InternVL2.5-4B: 36 layers -> 37 states
    return Qwen2Config(
        vocab_size=151674, hidden_size=2048, intermediate_size=11008,
        num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=2,
        head_dim=128, rope_theta=1000000.0)


def _minicpm_llm() -> Qwen2Config:
    # Qwen2-7B inside MiniCPM-o-2.6: 28 layers -> 29 states
    return Qwen2Config(
        vocab_size=151700, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        head_dim=128, rope_theta=1000000.0)


# internvl1b mixes the layers by a channel scale, the others by a conv
PROJ_REGISTRY: Dict[str, ProjConfig] = {
    "internvl1b": ProjConfig(in_channels=25, input_dim=896, num_heads=12,
                             head_dim=64, use_scale=True, use_cnn=False),
    "internvl4b": ProjConfig(in_channels=37, input_dim=2048, num_heads=16,
                             head_dim=128),
    "qwen3b": ProjConfig(in_channels=37, input_dim=2048, num_heads=28,
                         head_dim=128),
    "qwen7b": ProjConfig(in_channels=29, input_dim=3584, num_heads=28,
                         head_dim=128),
    "minicpm": ProjConfig(in_channels=29, input_dim=3584, num_heads=28,
                          head_dim=128),
}


@dataclass(frozen=True)
class ModelSpec:
    """One registry entry: the LM, proj, DiT and scheduler, and for the
    InternVL2.5 and MiniCPM-o entries the encoder's config (its ``llm``
    is ``llm``)."""

    llm: Qwen2Config = field(default_factory=Qwen2Config)
    proj: ProjConfig = field(default_factory=ProjConfig)
    flux: FluxConfig = field(default_factory=FluxConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    internvl: Optional[InternVLConfig] = None
    minicpmo: Optional[MiniCPMOConfig] = None


def _schnell(llm: Qwen2Config, proj: str,
             internvl: bool = False) -> ModelSpec:
    """An entry on FLUX.1-schnell: 4 steps, no guidance embedder, shift 1."""
    return ModelSpec(
        llm=llm, proj=PROJ_REGISTRY[proj],
        flux=FluxConfig(guidance_embeds=False),
        scheduler=SchedulerConfig(shift=1.0, use_dynamic_shifting=False),
        internvl=InternVLConfig(llm=llm) if internvl else None,
        minicpmo=MiniCPMOConfig(llm=llm) if proj == "minicpm" else None)


# The encoder family is in the name (internvl, qwenvl, minicpm), as the
# checkpoint loader reads it.
MODEL_REGISTRY: Dict[str, ModelSpec] = {
    "x2i-internvl2.5-1b": _schnell(Qwen2Config(), "internvl1b", True),
    "x2i-internvl2.5-4b": _schnell(_internvl_4b_llm(), "internvl4b", True),
    "x2i-qwenvl2.5-3b": _schnell(_qwen2_5_vl_3b_llm(), "qwen3b"),
    "x2i-qwenvl2.5-7b": _schnell(_qwen2_5_vl_7b_llm(), "qwen7b"),
    "x2i-minicpm-o-2.6": _schnell(_minicpm_llm(), "minicpm"),
    # FLUX.1-dev: 28 steps, the guidance embedder, dynamic shifting
    "x2i-minicpm-o-2.6-dev": ModelSpec(
        llm=_minicpm_llm(), proj=PROJ_REGISTRY["minicpm"],
        flux=FluxConfig(guidance_embeds=True),
        scheduler=SchedulerConfig(shift=3.0, use_dynamic_shifting=True),
        minicpmo=MiniCPMOConfig(llm=_minicpm_llm())),
}


def tiny_flux_config(**overrides) -> FluxConfig:
    """A miniature FLUX used by tests and CPU dry-runs."""
    base = dict(
        num_layers=2, num_single_layers=4, attention_head_dim=32,
        num_attention_heads=4, joint_attention_dim=64,
        pooled_projection_dim=32, time_embed_dim=32,
        axes_dims_rope=(8, 12, 12), dtype=torch.float32,
        attention_impl="plain")
    base.update(overrides)
    return FluxConfig(**base)


def tiny_qwen2_config(**overrides) -> Qwen2Config:
    base = dict(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, dtype=torch.float32, attention_impl="plain")
    base.update(overrides)
    return Qwen2Config(**base)
