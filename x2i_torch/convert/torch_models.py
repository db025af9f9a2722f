"""diffusers / HF / reference state dicts into the port's modules, the
counterpart of ``x2i_tpu/convert/torch_models.py`` and of the VAE
converter of ``x2i_tpu/convert/load.py``.

The JAX converters build param trees: every tensor to float32 numpy, the
layers stacked for ``nn.scan``, the Linear weights transposed. The port's
modules have torch's own layouts (``nn.Linear`` (out, in), ``nn.Conv2d``
OIHW, one module per layer), so a converter here is a *plan*: for each key
of the checkpoint, the parameter or buffer of the port module that takes
it, and the row permutation it needs on the way, if any (a key may fill
several: MiniCPM-o's packed in-projection is split into q, k and v
rows). ``fill_module``
then copies the checkpoint into the module where it lies, one tensor at a
time, in the module's dtype (a bf16 file is copied as it is): no
float32 copy of the checkpoint and no stacking on the host.

The accounting is strict: the plan names every parameter and buffer of
the module exactly once, every key of the plan must be in the
checkpoint, and a key outside the plan must be one the port does not
read (``off_path``: MiniCPM-o's TTS modules, the SigLIP block MiniCPM
drops and Whisper's stored position table, a tied head), which the
returned report names. Anything else raises. The
InternVL2.5, Qwen2.5-VL and MiniCPM-o plans fill the whole encoder, the
vision (and audio) towers and the LM, in one pass over the directory;
MiniCPM-o's speech modules have their own plans (``chattts_plan``,
``dvae_plan``), which read its ``tts.`` keys strictly.

FLUX's q/k projections (weights and biases) and its qk-norm scales leave
in the half-rope layout (``x2i_torch/ops/rope.py::half_layout_perm`` over
the channels of each head), as the JAX converter's
``permute_params_to_half_rope`` leaves them; a config with
``rope_layout="interleaved"`` takes them as stored.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from x2i_torch.core.config import (CLIPTextConfig, CLIPVisionConfig,
                                   ControlNeXtConfig, FluxConfig,
                                   InternVLConfig, MiniCPMOConfig,
                                   ProjConfig, Qwen2Config, T5Config,
                                   VAEConfig)
from x2i_torch.models.chattts import ChatTTSConfig
from x2i_torch.models.qwen2_5_vl import Qwen2_5_VLConfig
from x2i_torch.ops.quant import note_pre_scales_
from x2i_torch.ops.rope import half_layout_perm

# checkpoint key -> (the module's parameter or buffer name, a transform
# applied on the module's device, or None), or a list of such pairs for a
# key that fills several
Target = Tuple[str, Optional[Callable[[torch.Tensor], torch.Tensor]]]
Plan = Dict[str, Union[Target, List[Target]]]


def _rows(index: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda t: t.index_select(0, index.to(t.device))


def flux_plan(cfg: FluxConfig) -> Plan:
    """diffusers FluxTransformer2DModel -> ``FluxTransformer2D``.

    Double blocks ``transformer_blocks.{i}.``: norm1.linear -> img_mod,
    norm1_context.linear -> txt_mod, attn.to_{q,k,v} -> img_{q,k,v},
    attn.add_{q,k,v}_proj -> txt_{q,k,v}, attn.norm_{q,k} ->
    img_{q,k}_norm, attn.norm_added_{q,k} -> txt_{q,k}_norm,
    attn.to_out.0 -> img_attn_out, attn.to_add_out -> txt_attn_out,
    ff.net.0.proj / ff.net.2 -> img_mlp_in / img_mlp_out, ff_context.* ->
    txt_mlp_*. Single blocks ``single_transformer_blocks.{i}.``:
    norm.linear -> mod, attn.to_{q,k,v} -> {q,k,v}, attn.norm_{q,k} ->
    {q,k}_norm, proj_mlp -> mlp_in, proj_out -> out. Top level:
    x_embedder, context_embedder and proj_out keep their names,
    norm_out.linear -> norm_out (diffusers' (scale, shift) chunk order is
    the model's), time_text_embed.{timestep,text,guidance}_embedder.
    linear_{1,2} -> {time,pooled,guidance}_embedder.{in,out}_layer. The
    q/k rows and qk-norm scales are permuted into the half layout only
    for ``cfg.rope_layout == "half"``."""
    d = cfg.attention_head_dim
    perm = torch.from_numpy(half_layout_perm(d))
    full = torch.cat([h * d + perm for h in range(cfg.num_attention_heads)])
    half = cfg.rope_layout == "half"
    plan: Plan = {}

    def lin(src, dst, rows=None):
        for leaf in ("weight", "bias"):
            plan[f"{src}.{leaf}"] = (f"{dst}.{leaf}", rows if half else None)

    def norm(src, dst):
        plan[f"{src}.weight"] = (f"{dst}.scale", _rows(perm) if half
                                 else None)

    for i in range(cfg.num_layers):
        s, t = f"transformer_blocks.{i}.", f"double_blocks.{i}."
        lin(s + "norm1.linear", t + "img_mod")
        lin(s + "norm1_context.linear", t + "txt_mod")
        for n in ("q", "k", "v"):
            qk = _rows(full) if n != "v" else None
            lin(f"{s}attn.to_{n}", f"{t}img_{n}", qk)
            lin(f"{s}attn.add_{n}_proj", f"{t}txt_{n}", qk)
        for n in ("q", "k"):
            norm(f"{s}attn.norm_{n}", f"{t}img_{n}_norm")
            norm(f"{s}attn.norm_added_{n}", f"{t}txt_{n}_norm")
        lin(s + "attn.to_out.0", t + "img_attn_out")
        lin(s + "attn.to_add_out", t + "txt_attn_out")
        lin(s + "ff.net.0.proj", t + "img_mlp_in")
        lin(s + "ff.net.2", t + "img_mlp_out")
        lin(s + "ff_context.net.0.proj", t + "txt_mlp_in")
        lin(s + "ff_context.net.2", t + "txt_mlp_out")
    for i in range(cfg.num_single_layers):
        s, t = f"single_transformer_blocks.{i}.", f"single_blocks.{i}."
        lin(s + "norm.linear", t + "mod")
        for n in ("q", "k", "v"):
            lin(f"{s}attn.to_{n}", f"{t}{n}",
                _rows(full) if n != "v" else None)
        for n in ("q", "k"):
            norm(f"{s}attn.norm_{n}", f"{t}{n}_norm")
        lin(s + "proj_mlp", t + "mlp_in")
        lin(s + "proj_out", t + "out")
    for n in ("x_embedder", "context_embedder", "proj_out"):
        lin(n, n)
    lin("norm_out.linear", "norm_out")
    embedders = [("timestep", "time"), ("text", "pooled")]
    if cfg.guidance_embeds:
        embedders.append(("guidance", "guidance"))
    for src, dst in embedders:
        lin(f"time_text_embed.{src}_embedder.linear_1",
            f"{dst}_embedder.in_layer")
        lin(f"time_text_embed.{src}_embedder.linear_2",
            f"{dst}_embedder.out_layer")
    return plan


def vae_plan(cfg: VAEConfig) -> Plan:
    """diffusers AutoencoderKL -> ``AutoencoderKL``, encoder and decoder.
    Encoder: down_blocks.{i}.resnets.{j} -> down_{i}_block_{j},
    down_blocks.{i}.downsamplers.0.conv -> down_{i}_downsample. Decoder:
    up_blocks.{i}.resnets.{j} -> up_{i}_block_{j}, up_blocks.{i}.
    upsamplers.0.conv -> up_{i}_upsample. Both: mid_block.resnets.{0,1} ->
    mid_block_{1,2}, mid_block.attentions.0 -> mid_attn (to_out.0 ->
    to_out), GroupNorm weight -> scale; conv_in, conv_norm_out and
    conv_out keep their names."""
    plan: Plan = {}
    ch = cfg.block_out_channels

    def half(part):
        def same(src, dst, gn=False):    # a conv or Linear, or a GroupNorm
            plan[f"{part}.{src}.weight"] = (
                f"{part}.{dst}.{'scale' if gn else 'weight'}", None)
            plan[f"{part}.{src}.bias"] = (f"{part}.{dst}.bias", None)

        def resnet(src, dst, cin, cout):
            for n in ("norm1", "conv1", "norm2", "conv2"):
                same(f"{src}.{n}", f"{dst}.{n}", gn=n.startswith("norm"))
            if cin != cout:
                same(f"{src}.conv_shortcut", f"{dst}.conv_shortcut")

        same("conv_in", "conv_in")
        resnet("mid_block.resnets.0", "mid_block_1", ch[-1], ch[-1])
        resnet("mid_block.resnets.1", "mid_block_2", ch[-1], ch[-1])
        if cfg.use_mid_attention:
            a = "mid_block.attentions.0"
            same(f"{a}.group_norm", "mid_attn.group_norm", gn=True)
            for n in ("to_q", "to_k", "to_v"):
                same(f"{a}.{n}", f"mid_attn.{n}")
            same(f"{a}.to_out.0", "mid_attn.to_out")
        same("conv_norm_out", "conv_norm_out", gn=True)
        same("conv_out", "conv_out")
        return same, resnet

    same, resnet = half("encoder")
    cin = ch[0]
    for i, c in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"down_blocks.{i}.resnets.{j}", f"down_{i}_block_{j}",
                   cin, c)
            cin = c
        if i < len(ch) - 1:
            same(f"down_blocks.{i}.downsamplers.0.conv",
                 f"down_{i}_downsample")
    same, resnet = half("decoder")
    cin = ch[-1]
    for i, c in enumerate(reversed(ch)):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", f"up_{i}_block_{j}", cin, c)
            cin = c
        if i < len(ch) - 1:
            same(f"up_blocks.{i}.upsamplers.0.conv", f"up_{i}_upsample")
    return plan


def controlnext_plan(cfg: ControlNeXtConfig, num_controls: int) -> Plan:
    """The reference's bank, ``nn.ModuleList([ControlNeXtModel] * n)``
    (what its trainer saves), -> ``ControlBank``: branch ``{i}.`` ->
    branches.{i}., time_embedding.linear_{1,2} -> time_linear{1,2},
    embedding.{0,3,6} / {1,4,7} -> stem{0,1,2} / stem_norm{0,1,2},
    down_res.{j}.* -> res_{j}.* (norm1, conv1, time_emb_proj, norm2,
    conv2, conv_shortcut), down_sample.{j}.conv -> down_{j},
    mid_convs.0.{0,2,3,4} -> mid0, mid_norm0, mid1, mid_norm1,
    mid_convs.1 -> out_conv; GroupNorm weight -> scale. The counterpart
    of JAX's ``controlnext_bank_params_from_reference``."""
    plan: Plan = {}
    for i in range(num_controls):
        def same(src, dst, gn=False):
            plan[f"{i}.{src}.weight"] = (
                f"branches.{i}.{dst}.{'scale' if gn else 'weight'}", None)
            plan[f"{i}.{src}.bias"] = (f"branches.{i}.{dst}.bias", None)

        same("time_embedding.linear_1", "time_linear1")
        same("time_embedding.linear_2", "time_linear2")
        for k in range(3):
            same(f"embedding.{3 * k}", f"stem{k}")
            same(f"embedding.{3 * k + 1}", f"stem_norm{k}", gn=True)
        cin = 128
        for j, cout in enumerate(cfg.out_channels):
            for n in ("norm1", "conv1", "time_emb_proj", "norm2", "conv2"):
                same(f"down_res.{j}.{n}", f"res_{j}.{n}",
                     gn=n.startswith("norm"))
            if cin != cout:
                same(f"down_res.{j}.conv_shortcut",
                     f"res_{j}.conv_shortcut")
            same(f"down_sample.{j}.conv", f"down_{j}")
            cin = cout
        for src, dst in (("0.0", "mid0"), ("0.2", "mid_norm0"),
                         ("0.3", "mid1"), ("0.4", "mid_norm1"),
                         ("1", "out_conv")):
            same(f"mid_convs.{src}", dst, gn="norm" in dst)
    return plan


def qwen2_plan(cfg: Qwen2Config, body: str = "model.",
               head: str = "lm_head.weight") -> Plan:
    """HF Qwen2ForCausalLM -> ``Qwen2LM``, its decoder under ``body``
    (``model.`` in a Qwen2 checkpoint; ``language_model.model.`` in
    InternVL, ``model.language_model.`` or ``model.`` in Qwen2.5-VL,
    ``llm.model.`` in MiniCPM-o) and an untied head at ``head``.
    input_layernorm / post_attention_layernorm -> input_norm /
    post_attn_norm, norm -> final_norm, self_attn.* and mlp.* keep their
    names."""
    plan: Plan = {f"{body}embed_tokens.weight": ("embed_tokens.weight", None),
                  f"{body}norm.weight": ("final_norm.scale", None)}
    for i in range(cfg.num_hidden_layers):
        s, t = f"{body}layers.{i}.", f"layers.{i}."
        plan[s + "input_layernorm.weight"] = (t + "input_norm.scale", None)
        plan[s + "post_attention_layernorm.weight"] = (
            t + "post_attn_norm.scale", None)
        for n in ("q", "k", "v", "o"):
            leaves = ("weight", "bias") if n != "o" and cfg.attention_bias \
                else ("weight",)
            for leaf in leaves:
                plan[f"{s}self_attn.{n}_proj.{leaf}"] = (
                    f"{t}{n}_proj.{leaf}", None)
        for n in ("gate", "up", "down"):
            plan[f"{s}mlp.{n}_proj.weight"] = (f"{t}{n}_proj.weight", None)
    if not cfg.tie_word_embeddings:
        plan[head] = ("lm_head.weight", None)
    return plan


def internlm2_plan(cfg: Qwen2Config, body: str = "model.",
                  head: str = "output.weight") -> Plan:
    """An InternLM2 checkpoint (InternVL2.5-2B/8B-class LMs) ->
    ``Qwen2LM``, the counterpart of JAX's ``internlm2_params_from_hf``.
    InternLM2 packs q, k and v into one ``attention.wqkv`` whose rows are
    grouped (h_kv, g + 2, d): per kv head, its g query heads, then its key,
    then its value; they are split here into q_proj, k_proj and v_proj
    (the query heads in the order kv_head * g + j, the GQA map h -> h //
    g). tok_embeddings -> embed_tokens, attention_norm / ffn_norm ->
    input_norm / post_attn_norm, attention.wo -> o_proj, feed_forward.w1 /
    w3 / w2 -> gate_proj / up_proj / down_proj, norm -> final_norm, an
    untied ``output`` -> lm_head. The config has no attention bias."""
    if cfg.attention_bias:
        raise ValueError("InternLM2 has no q/k/v bias: attention_bias=False")
    h, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.head_dim)
    g = h // hk
    group = torch.arange(hk * (g + 2) * d).view(hk, g + 2, d)
    rows = {"q": group[:, :g].reshape(-1), "k": group[:, g].reshape(-1),
            "v": group[:, g + 1].reshape(-1)}
    plan: Plan = {f"{body}tok_embeddings.weight": ("embed_tokens.weight",
                                                   None),
                  f"{body}norm.weight": ("final_norm.scale", None)}
    for i in range(cfg.num_hidden_layers):
        s, t = f"{body}layers.{i}.", f"layers.{i}."
        plan[s + "attention_norm.weight"] = (t + "input_norm.scale", None)
        plan[s + "ffn_norm.weight"] = (t + "post_attn_norm.scale", None)
        plan[s + "attention.wqkv.weight"] = [
            (f"{t}{n}_proj.weight", _rows(rows[n])) for n in ("q", "k", "v")]
        plan[s + "attention.wo.weight"] = (t + "o_proj.weight", None)
        for src, dst in (("w1", "gate"), ("w3", "up"), ("w2", "down")):
            plan[f"{s}feed_forward.{src}.weight"] = (f"{t}{dst}_proj.weight",
                                                     None)
    if not cfg.tie_word_embeddings:
        plan[head] = ("lm_head.weight", None)
    return plan


def _prefixed(plan: Plan, prefix: str) -> Plan:
    """The plan of a submodule, its destinations under ``prefix``."""
    return {k: (prefix + name, fn) for k, (name, fn) in plan.items()}


def internvl_plan(cfg: InternVLConfig) -> Plan:
    """HF InternVLChatModel -> ``InternVLEncoder``: vision_model.
    embeddings.{class_embedding, position_embedding, patch_embedding} keep
    their names (the conv in torch's layout), vision_model.encoder.
    layers.{i}.* -> vision_model.block.{i}.* (norm weights -> scale,
    attn.qkv / attn.proj -> qkv / proj, mlp.fc1 / fc2 -> fc1 / fc2,
    attn.{q,k}_norm.weight -> {q,k}_norm_scale, ls1, ls2); mlp1.{0,1,3}
    -> mlp1_norm, mlp1_fc1, mlp1_fc2; the LM under
    ``language_model.model.`` (an untied head at
    ``language_model.lm_head.weight``) -> language_model."""
    v = cfg.vision
    plan: Plan = {}

    def same(src, dst, bias=True, norm=False):
        plan[f"{src}.weight"] = (f"{dst}.{'scale' if norm else 'weight'}",
                                 None)
        if bias:
            plan[f"{src}.bias"] = (f"{dst}.bias", None)

    e = "vision_model.embeddings."
    for n in ("class_embedding", "position_embedding"):
        plan[e + n] = (f"vision_model.{n}", None)
    same(e + "patch_embedding", "vision_model.patch_embedding")
    for i in range(v.num_hidden_layers):
        s, t = f"vision_model.encoder.layers.{i}.", f"vision_model.block.{i}."
        same(s + "norm1", t + "norm1", norm=True)
        same(s + "norm2", t + "norm2", norm=True)
        same(s + "attn.qkv", t + "qkv", bias=v.qkv_bias)
        same(s + "attn.proj", t + "proj")
        same(s + "mlp.fc1", t + "fc1")
        same(s + "mlp.fc2", t + "fc2")
        for n in ("ls1", "ls2"):
            plan[s + n] = (t + n, None)
        if v.qk_normalization:
            for n in ("q", "k"):
                plan[f"{s}attn.{n}_norm.weight"] = (f"{t}{n}_norm_scale",
                                                    None)
    same("mlp1.0", "mlp1_norm", norm=True)
    same("mlp1.1", "mlp1_fc1")
    same("mlp1.3", "mlp1_fc2")
    plan.update(_prefixed(qwen2_plan(cfg.llm, "language_model.model.",
                                     "language_model.lm_head.weight"),
                          "language_model."))
    return plan


def qwen2_5_vl_plan(cfg: Qwen2_5_VLConfig, vis: str = "visual.",
                    body: str = "model.", head: str = "lm_head.weight"
                    ) -> Plan:
    """HF Qwen2.5-VL -> ``Qwen2_5_VLEncoder``: the tower under ``vis``
    (``visual.`` or ``model.visual.``) -> visual: patch_embed.proj.weight
    (E, C, tps, ps, ps) -> patch_embed.weight flattened to (E, C * tps *
    ps^2), blocks.{i}.* -> block.{i}.* (norm weights -> scale, attn.qkv /
    attn.proj -> qkv / proj, mlp.{gate,up,down}_proj keep their names),
    merger.ln_q -> ln_q, merger.mlp.{0,2} -> merger_fc{1,2}; the LM under
    ``body`` -> language_model."""
    v = cfg.vision
    plan: Plan = {f"{vis}patch_embed.proj.weight": (
        "visual.patch_embed.weight", lambda t: t.reshape(t.shape[0], -1))}
    for i in range(v.depth):
        s, t = f"{vis}blocks.{i}.", f"visual.block.{i}."
        for n in ("norm1", "norm2"):
            plan[f"{s}{n}.weight"] = (f"{t}{n}.scale", None)
        for src, dst in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                         ("mlp.gate_proj", "gate_proj"),
                         ("mlp.up_proj", "up_proj"),
                         ("mlp.down_proj", "down_proj")):
            for leaf in ("weight", "bias"):
                plan[f"{s}{src}.{leaf}"] = (f"{t}{dst}.{leaf}", None)
    plan[f"{vis}merger.ln_q.weight"] = ("visual.ln_q.scale", None)
    for src, dst in (("0", "merger_fc1"), ("2", "merger_fc2")):
        for leaf in ("weight", "bias"):
            plan[f"{vis}merger.mlp.{src}.{leaf}"] = (f"visual.{dst}.{leaf}",
                                                     None)
    plan.update(_prefixed(qwen2_plan(cfg.llm, body, head),
                          "language_model."))
    return plan


def _split(i: int, n: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The i-th of n equal row blocks."""
    return lambda t: t.chunk(n, dim=0)[i]


def minicpmo_plan(cfg: MiniCPMOConfig) -> Plan:
    """HF MiniCPM-o-2.6 -> ``MiniCPMOEncoder``. ``vpm.``: embeddings.
    patch_embedding.weight (d, 3, ps, ps) -> vpm.patch_embedding.weight
    flattened in (c, py, px) order, embeddings.position_embedding ->
    position_embedding, encoder.layers.{i}.* -> block.{i}.* for the
    ``effective_layers`` used (layer_norm1/2 -> ln1/ln2, self_attn.
    {q,k,v}_proj / out_proj -> q, k, v / o, mlp.fc1/fc2 -> fc1/fc2),
    post_layernorm. ``resampler.``: query and proj as stored, kv_proj
    (where SigLIP's width is not the LM's), ln_{q,kv,post}, attn.
    in_proj_weight / _bias split in three row blocks -> in_proj_{q,k,v},
    attn.out_proj -> out_proj. ``apm.``: conv1 / conv2 in torch's
    layout, layers.{i}.* -> block.{i}.* (self_attn_layer_norm /
    final_layer_norm -> attn_ln / ffn_ln, self_attn.{q,k,v}_proj /
    out_proj -> q, k (no bias), v / o, fc1, fc2), layer_norm -> final_ln.
    audio_projection_layer.linear1/2 -> audio_projector.linear1/2; the LM
    under ``llm.model.`` (an untied head at ``llm.lm_head.weight``) ->
    llm. Norm weights -> scale."""
    plan: Plan = {}

    def same(src, dst, bias=True, norm=False):
        plan[f"{src}.weight"] = (f"{dst}.{'scale' if norm else 'weight'}",
                                 None)
        if bias:
            plan[f"{src}.bias"] = (f"{dst}.bias", None)

    e = "vpm.embeddings."
    plan[e + "patch_embedding.weight"] = (
        "vpm.patch_embedding.weight", lambda t: t.reshape(t.shape[0], -1))
    plan[e + "patch_embedding.bias"] = ("vpm.patch_embedding.bias", None)
    plan[e + "position_embedding.weight"] = (
        "vpm.position_embedding.weight", None)
    for i in range(cfg.vision.effective_layers):
        s, t = f"vpm.encoder.layers.{i}.", f"vpm.block.{i}."
        same(s + "layer_norm1", t + "ln1", norm=True)
        same(s + "layer_norm2", t + "ln2", norm=True)
        for n in ("q", "k", "v"):
            same(f"{s}self_attn.{n}_proj", t + n)
        same(s + "self_attn.out_proj", t + "o")
        same(s + "mlp.fc1", t + "fc1")
        same(s + "mlp.fc2", t + "fc2")
    same("vpm.post_layernorm", "vpm.post_layernorm", norm=True)

    r = "resampler."
    for n in ("query", "proj"):
        plan[r + n] = (r + n, None)
    if cfg.vision.hidden_size != cfg.llm.hidden_size:
        same(r + "kv_proj", r + "kv_proj", bias=False)
    for n in ("ln_q", "ln_kv", "ln_post"):
        same(r + n, r + n, norm=True)
    for leaf in ("weight", "bias"):
        plan[f"{r}attn.in_proj_{leaf}"] = [
            (f"{r}in_proj_{n}.{leaf}", _split(i, 3))
            for i, n in enumerate("qkv")]
    same(r + "attn.out_proj", r + "out_proj")

    same("apm.conv1", "apm.conv1")
    same("apm.conv2", "apm.conv2")
    for i in range(cfg.audio.encoder_layers):
        s, t = f"apm.layers.{i}.", f"apm.block.{i}."
        same(s + "self_attn_layer_norm", t + "attn_ln", norm=True)
        same(s + "final_layer_norm", t + "ffn_ln", norm=True)
        for n in ("q", "k", "v"):
            same(f"{s}self_attn.{n}_proj", t + n, bias=n != "k")
        same(s + "self_attn.out_proj", t + "o")
        same(s + "fc1", t + "fc1")
        same(s + "fc2", t + "fc2")
    same("apm.layer_norm", "apm.final_ln", norm=True)
    for n in ("linear1", "linear2"):
        same(f"audio_projection_layer.{n}", f"audio_projector.{n}")
    plan.update(_prefixed(qwen2_plan(cfg.llm, "llm.model.",
                                     "llm.lm_head.weight"), "llm."))
    return plan


def minicpmo_off_path(cfg: MiniCPMOConfig) -> Callable[[str], bool]:
    """The keys of a MiniCPM-o directory that the port does not read, as
    JAX reads none of them: the TTS modules (``tts.``), SigLIP's blocks
    past ``effective_layers`` (MiniCPM drops the last), Whisper's stored
    position table (the encoder makes its sinusoids) and a tied head."""
    used = cfg.vision.effective_layers
    layer = re.compile(r"vpm\.encoder\.layers\.(\d+)\.")

    def off(key: str) -> bool:
        m = layer.match(key)
        return (key.startswith("tts.")
                or key == "apm.embed_positions.weight"
                or bool(m and int(m.group(1)) >= used)
                or (cfg.llm.tie_word_embeddings
                    and key == "llm.lm_head.weight"))
    return off


def chattts_plan(cfg: ChatTTSConfig, keys: Iterable[str],
                 prefix: str = "tts.") -> Plan:
    """MiniCPM-o's ConditionalChatTTS (its ``tts.`` keys, the DVAE's
    apart) -> ``ConditionalChatTTS``: model.layers.{i}.* ->
    blocks.{i}.* (as ``qwen2_plan``), model.norm -> norm, emb_text and
    emb_code.{i} -> emb_code_{i}, the weight-normed head_code.{i} in
    either of torch's layouts (parametrizations.weight.original0 / 1 or
    weight_g / weight_v, whichever ``keys`` hold) -> head_g_{i} (flat) /
    head_v_{i}, projector.linear{1,2} (``use_mlp``) or projector. The
    counterpart of JAX's ``chattts_params_from_reference``."""
    keys = set(keys)
    plan: Plan = {}
    for key, (name, fn) in qwen2_plan(cfg.backbone,
                                      prefix + "model.").items():
        if name == "final_norm.scale":
            plan[key] = ("norm.scale", fn)
        elif name.startswith("layers."):
            plan[key] = ("blocks." + name.removeprefix("layers."), fn)
    plan[prefix + "emb_text.weight"] = ("emb_text.weight", None)
    flat = lambda t: t.reshape(-1)          # noqa: E731  (out, 1) -> (out,)
    for i in range(cfg.num_vq):
        plan[f"{prefix}emb_code.{i}.weight"] = (f"emb_code_{i}.weight", None)
        head = f"{prefix}head_code.{i}."
        g, v = (("parametrizations.weight.original0",
                 "parametrizations.weight.original1")
                if head + "parametrizations.weight.original0" in keys
                else ("weight_g", "weight_v"))
        plan[head + g] = (f"head_g_{i}", flat)
        plan[head + v] = (f"head_v_{i}", None)
    names = ([f"linear{j}.{leaf}" for j in (1, 2)
              for leaf in ("weight", "bias")] if cfg.use_mlp else ["weight"])
    for n in names:
        plan[f"{prefix}projector.{n}"] = (f"projector.{n}", None)
    return plan


def chattts_off_path(prefix: str = "tts.") -> Callable[[str], bool]:
    """The ``tts.`` key the port does not read, as JAX does not: the
    Llama's own token table (``model.embed_tokens``), where a checkpoint
    keeps it; the GPT is given embeddings."""
    return lambda key: key == prefix + "model.embed_tokens.weight"


def dvae_quantizer_in(keys: Iterable[str], prefix: str = "tts.dvae.") -> bool:
    """Whether a checkpoint holds the DVAE's FSQ projections; JAX's
    converter skips them where ``vq_layer`` was stripped."""
    return prefix + "vq_layer.quantizer.rvqs.0.project_in.weight" in set(keys)


def dvae_plan(quantizer: bool = True, prefix: str = "tts.dvae.") -> Plan:
    """The reference's DVAE -> ``DVAE`` (``quantizer``: with its FSQ
    projections): coef (1, 100, 1) -> coef (100,), downsample_conv.{0,2}
    -> down0 / down1, encoder. and decoder.: conv_in.{0,2} -> conv_in0 /
    conv_in1, conv_out, decoder_block.{i}.* -> block_{i}.* (norm weight ->
    scale), out_conv, vq_layer.quantizer.rvqs.{g}.project_{in,out} ->
    vq.project_{in,out}_{g}. The counterpart of JAX's
    ``dvae_params_from_reference``."""
    plan: Plan = {prefix + "coef": ("coef", lambda t: t.reshape(-1))}

    def same(src, dst, bias=True):
        plan[f"{prefix}{src}.weight"] = (f"{dst}.weight", None)
        if bias:
            plan[f"{prefix}{src}.bias"] = (f"{dst}.bias", None)

    same("downsample_conv.0", "down0")
    same("downsample_conv.2", "down1")
    same("out_conv", "out_conv", bias=False)
    for part in ("encoder", "decoder"):
        same(f"{part}.conv_in.0", f"{part}.conv_in0")
        same(f"{part}.conv_in.2", f"{part}.conv_in1")
        same(f"{part}.conv_out", f"{part}.conv_out", bias=False)
        for i in range(12):
            s, t = f"{part}.decoder_block.{i}.", f"{part}.block_{i}."
            for n in ("dwconv", "pwconv1", "pwconv2"):
                same(s + n, t + n)
            plan[f"{prefix}{s}norm.weight"] = (t + "norm.scale", None)
            plan[f"{prefix}{s}norm.bias"] = (t + "norm.bias", None)
            plan[f"{prefix}{s}coef"] = (t + "coef", None)
    if quantizer:
        for g in (0, 1):
            for n in ("in", "out"):
                same(f"vq_layer.quantizer.rvqs.{g}.project_{n}",
                     f"vq.project_{n}_{g}")
    return plan


def t5_plan(cfg: T5Config) -> Plan:
    """HF T5EncoderModel -> ``T5Encoder``: shared.weight -> shared,
    encoder.block.{i}.layer.0 (layer_norm, SelfAttention.{q,k,v,o}) ->
    encoder.block.{i}.{attn_norm, q, k, v, o}, layer.1 (layer_norm,
    DenseReluDense.{wi_0,wi_1,wo}) -> {ff_norm, wi_0, wi_1, wo}, block 0's
    relative_attention_bias -> encoder.rel_bias (shared by every layer),
    final_layer_norm -> encoder.final_norm."""
    plan: Plan = {"shared.weight": ("shared.weight", None),
                  "encoder.final_layer_norm.weight": (
                      "encoder.final_norm.scale", None),
                  "encoder.block.0.layer.0.SelfAttention."
                  "relative_attention_bias.weight": ("encoder.rel_bias",
                                                     None)}
    for i in range(cfg.num_layers):
        s, t = f"encoder.block.{i}.layer.", f"encoder.block.{i}."
        plan[s + "0.layer_norm.weight"] = (t + "attn_norm.scale", None)
        plan[s + "1.layer_norm.weight"] = (t + "ff_norm.scale", None)
        for n in ("q", "k", "v", "o"):
            plan[f"{s}0.SelfAttention.{n}.weight"] = (f"{t}{n}.weight", None)
        for n in ("wi_0", "wi_1", "wo"):
            plan[f"{s}1.DenseReluDense.{n}.weight"] = (f"{t}{n}.weight",
                                                       None)
    return plan


_T5_OFF = re.compile(r"encoder\.embed_tokens\.weight|encoder\.block\.[1-9]"
                     r"\d*\.layer\.0\.SelfAttention\."
                     r"relative_attention_bias\.weight")


def t5_off_path(key: str) -> bool:
    """The T5 keys the port does not read, as JAX does not: the encoder's
    tied copy of ``shared.weight``, and a relative bias table of a block
    after the first (the port, like JAX, shares block 0's)."""
    return bool(_T5_OFF.fullmatch(key))


def _clip_block(plan: Plan, src: str, dst: str, cfg) -> None:
    """The CLIP encoder layers of either tower (HF layout under ``src``)
    -> ``CLIPBlock``s under ``dst``."""
    for i in range(cfg.num_hidden_layers):
        s, t = f"{src}encoder.layers.{i}.", f"{dst}block.{i}."
        for a, b in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            plan[f"{s}{a}.weight"] = (f"{t}{b}.scale", None)
            plan[f"{s}{a}.bias"] = (f"{t}{b}.bias", None)
        for a, b in (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
                     ("self_attn.v_proj", "v"), ("self_attn.out_proj", "o"),
                     ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            for leaf in ("weight", "bias"):
                plan[f"{s}{a}.{leaf}"] = (f"{t}{b}.{leaf}", None)


def clip_text_plan(cfg: CLIPTextConfig, src: str = "text_model.",
                   dst: str = "") -> Plan:
    """HF CLIPTextModel (under ``src``) -> ``CLIPTextEncoder`` (under
    ``dst``): embeddings.{token,position}_embedding -> token_embedding,
    position_embedding; encoder.layers.{i}.{layer_norm1, layer_norm2,
    self_attn.{q,k,v,out}_proj, mlp.fc1, mlp.fc2} -> block.{i}.{ln1, ln2,
    q, k, v, o, fc1, fc2}; final_layer_norm -> final_ln."""
    plan: Plan = {
        f"{src}embeddings.token_embedding.weight": (
            f"{dst}token_embedding.weight", None),
        f"{src}embeddings.position_embedding.weight": (
            f"{dst}position_embedding", None),
        f"{src}final_layer_norm.weight": (f"{dst}final_ln.scale", None),
        f"{src}final_layer_norm.bias": (f"{dst}final_ln.bias", None)}
    _clip_block(plan, src, dst, cfg)
    return plan


def clip_vision_plan(cfg: CLIPVisionConfig, src: str = "vision_model.",
                     dst: str = "") -> Plan:
    """HF CLIPVisionModel (under ``src``) -> ``CLIPVisionEncoder`` (under
    ``dst``): embeddings.{class_embedding, patch_embedding (no bias),
    position_embedding} keep their names, pre_layrnorm (HF's spelling) ->
    pre_layernorm, the layers as the text tower's, post_layernorm."""
    e = f"{src}embeddings."
    plan: Plan = {
        e + "class_embedding": (f"{dst}class_embedding", None),
        e + "patch_embedding.weight": (f"{dst}patch_embedding.weight", None),
        e + "position_embedding.weight": (f"{dst}position_embedding", None)}
    for a, b in (("pre_layrnorm", "pre_layernorm"),
                 ("post_layernorm", "post_layernorm")):
        plan[f"{src}{a}.weight"] = (f"{dst}{b}.scale", None)
        plan[f"{src}{a}.bias"] = (f"{dst}{b}.bias", None)
    _clip_block(plan, src, dst, cfg)
    return plan


def clip_plan(text_cfg: CLIPTextConfig, vision_cfg: CLIPVisionConfig
              ) -> Plan:
    """HF CLIPModel -> ``CLIPModel``: both towers and the projections
    (text_projection.weight, visual_projection.weight), read in one pass
    by the scorer."""
    plan = clip_text_plan(text_cfg, dst="text_model.")
    plan.update(clip_vision_plan(vision_cfg, dst="vision_model."))
    for n in ("text_projection", "visual_projection"):
        plan[f"{n}.weight"] = (f"{n}.weight", None)
    return plan


def clip_off_path(text_only: bool) -> Callable[[str], bool]:
    """The CLIP keys the port does not read: ``logit_scale`` and the
    stored ``position_ids``; with ``text_only`` (the teacher's text tower
    read from a whole CLIPModel directory) also the vision tower and both
    projections."""
    off = ("vision_model.", "visual_projection.", "text_projection.")

    def off_path(key: str) -> bool:
        return (key == "logit_scale" or key.endswith(".position_ids")
                or (text_only and key.startswith(off)))
    return off_path


def proj_plan(cfg: ProjConfig, keys: Iterable[str] = ()) -> Plan:
    """The reference proj (utils/proj.py's state dict, 'module.' prefixes
    stripped) -> ``Proj``, in each of its three forms: a channel scale
    (``cha_scale``), a conv (``conv``) or neither (a mean). A proj with the
    T5 refiner (``cfg.use_t5``, from ``t5stack.`` keys among ``keys``)
    has no plan: JAX's ``proj_params_from_reference`` reads no
    ``t5stack.`` key either, and the refiner's layout in such a file is
    not guessed. Raises ValueError naming those keys."""
    if cfg.use_t5:
        t5 = sorted(k for k in keys if k.startswith("t5stack."))
        raise ValueError(f"proj: no converter for the T5 refiner's "
                         f"{len(t5)} keys ({t5[:4]}...): JAX's "
                         f"proj_params_from_reference reads none of them")
    plan: Plan = {}
    if cfg.use_scale:
        plan["cha_scale"] = ("cha_scale", None)
    elif cfg.use_cnn:
        plan["conv.weight"] = ("conv.weight", None)
        plan["conv.bias"] = ("conv.bias", None)
    plan.update({"mlp.layernorm.weight": ("ln_scale", None),
                 "mlp.layernorm.bias": ("ln_bias", None),
                 "mlp.projector.0.weight": ("proj_in.weight", None),
                 "mlp.projector.2.weight": ("proj_out.weight", None),
                 "mlp.fc.1.weight": ("pooled_out.weight", None),
                 "mlp.fc.1.bias": ("pooled_out.bias", None)})
    return plan


@torch.no_grad()
def fill_module(module: nn.Module,
                tensors: Iterable[Tuple[str, torch.Tensor]], plan: Plan,
                off_path: Callable[[str], bool] = lambda key: False
                ) -> Dict[str, object]:
    """Copy the checkpoint ``tensors`` ((key, tensor) pairs, read lazily)
    into ``module`` by ``plan``, tensor by tensor, on the module's device
    and in its dtype. -> a report: {"tensors": keys read, "bytes": their
    size in the checkpoint, "unread": the keys off the path, sorted}.
    Raises when the plan misses a parameter or buffer of the module or
    names one twice, when a key of the plan is absent, when a key is
    neither in the plan nor off the path, and on a shape mismatch."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    plan = {k: v if isinstance(v, list) else [v] for k, v in plan.items()}
    named: Dict[str, int] = {}
    for dests in plan.values():
        for name, _ in dests:
            named[name] = named.get(name, 0) + 1
    unfilled = sorted(set(targets) - set(named))
    wrong = sorted(n for n, c in named.items()
                   if n not in targets or c != 1)
    if unfilled or wrong:
        raise KeyError(f"{type(module).__name__}: the plan leaves "
                       f"{unfilled[:8]} unfilled and names {wrong[:8]} "
                       f"not once")
    seen, unread, size = set(), [], 0
    for key, t in tensors:
        if key not in plan:
            if not off_path(key):
                raise KeyError(f"{key}: not a tensor of "
                               f"{type(module).__name__}")
            unread.append(key)
            continue
        if key in seen:
            raise KeyError(f"{key}: given twice")
        size += t.numel() * t.element_size()
        for name, fn in plan[key]:
            dst = targets[name]
            part = t if fn is None else fn(t.to(dst.device))
            if tuple(part.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(part.shape)} does "
                                 f"not fit {name} {tuple(dst.shape)}")
            dst.copy_(part)
        seen.add(key)
    missing = sorted(set(plan) - seen)
    if missing:
        raise KeyError(f"{type(module).__name__}: the checkpoint lacks "
                       f"{len(missing)} keys: {missing[:8]}")
    note_pre_scales_(module)      # w4 pre_scales copied past the hooks
    return {"tensors": len(seen), "bytes": size, "unread": sorted(unread)}
