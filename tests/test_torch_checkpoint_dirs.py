"""The port's checkpoint loader end to end against the JAX package's, on
fixture directories in the released layouts (bf16, as released
checkpoints are): the same directory and the same tokenizer through
``x2i_torch.convert.load.build_pipeline_from_checkpoints`` (on the CPU)
and ``x2i_tpu.convert.load.build_pipeline_from_checkpoints``.

qwenvl uses ``tests/ckpt_fixtures.py``'s directory; internvl and minicpm
write their own here (a ``transformers`` Qwen2 under the family's prefix
beside the other modules' keys), since the fixture builders of those
families need the reference's sources. minicpm's directory holds every
module of MiniCPM-o's encoder (SigLIP, the resampler, Whisper and its
projector), so both loaders build the whole encoder from it; its text
path is also held against the JAX pieces it consists of (the template
through the same chat template, ``qwen2_params_from_hf`` on the
``llm.``-stripped keys, the JAX ``Qwen2LM``).

Bars (bf16 on both sides): hidden-state stacks within 1e-2 of their
largest magnitude at the worst element (measured 4.4e-3 to 4.7e-3, about
one bf16 step), uint8 images within 16 levels at the worst pixel and 1
level on average (measured 5 to 9 and 0.48 to 0.55 in bf16, w8 and w8a8:
the two DiTs round at other points over two steps).

Requests beyond a text prompt (media, ``use_answer``, a chat session)
are in test_torch_checkpoint_dirs_requests.py, on the same directories
and bars, so that the test runner's workers take both files at once."""

import glob
import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from ckpt_fixtures import (VOCAB_SIZE, build_family_checkpoints,
                           build_flux_dir, build_proj_bin,
                           write_tokenizer_dir)
from test_torch_params import one_thread  # noqa: F401 (autouse)
from x2i_tpu.convert import torch_models as jtm
from x2i_tpu.convert.hf_config import minicpmo_config_from_dir
from x2i_tpu.convert.load import \
    build_pipeline_from_checkpoints as jax_build
from x2i_tpu.core import config as jcfg
from x2i_tpu.models.qwen2 import Qwen2LM as JQwen2
from x2i_tpu.models.templates import (internvl2_5_prompt,
                                      minicpm_omni_content,
                                      task_instruction)
from x2i_torch.convert.load import build_pipeline_from_checkpoints
from x2i_torch.convert.torch_models import minicpmo_plan
from x2i_torch.core import config as tcfg
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.internvl import InternVLEncoder
from x2i_torch.models.minicpmo import MiniCPMOEncoder
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.qwen2_5_vl import QwenVisionTransformer
from x2i_torch.models.vae import AutoencoderKL, postprocess
from x2i_torch.ops.quant import QuantLinear
from x2i_torch.params import load_flax

PX, STEPS = 64, 2
PROMPTS = ("a lighthouse at dusk", "a bowl of ramen")
STACK_BAR, IMG_MAX, IMG_MEAN = 1e-2, 16, 1.0
LLM_KW = dict(vocab_size=VOCAB_SIZE, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=8, rope_theta=1e6,
              rms_norm_eps=1e-6, max_position_embeddings=32768)


def _to_bf16(root: str):
    """Every float tensor of the directory's safetensors and proj .bin
    rounded to bf16, in place."""
    for f in glob.glob(os.path.join(root, "**", "*.safetensors"),
                       recursive=True):
        sd = load_file(f)
        save_file({k: v.to(torch.bfloat16) if v.is_floating_point() else v
                   for k, v in sd.items()}, f)
    for f in glob.glob(os.path.join(root, "*.bin")):
        sd = torch.load(f, weights_only=True)
        torch.save({k: v.to(torch.bfloat16) for k, v in sd.items()}, f)


def _hf_lm(tied: bool, seed: int):
    from transformers import Qwen2Config as HFCfg
    from transformers import Qwen2ForCausalLM
    torch.manual_seed(seed)
    lm = Qwen2ForCausalLM(HFCfg(**LLM_KW, tie_word_embeddings=tied))
    return {k: v for k, v in lm.state_dict().items()
            if not (tied and k == "lm_head.weight")}


def _randn(g, *shape):
    return torch.randn(shape, generator=g) * 0.1


def build_internvl_text_dir(root: str, seed: int = 0) -> str:
    """An InternVLChatModel directory: a transformers Qwen2 under
    ``language_model.``, random tensors for every key of the InternViT and
    mlp1 that the JAX ``internvl_params_from_hf`` reads, the config.json
    ``internvl_config_from_dir`` reads, and the family's tokenizer."""
    path = os.path.join(root, "internvl")
    os.makedirs(path, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    c, p, size, layers = 32, 7, 28, 2
    sd = {"language_model." + k: v for k, v in _hf_lm(True, seed).items()}
    v = "vision_model."
    sd.update({
        v + "embeddings.class_embedding": _randn(g, 1, 1, c),
        v + "embeddings.position_embedding": _randn(
            g, 1, (size // p) ** 2 + 1, c),
        v + "embeddings.patch_embedding.weight": _randn(g, c, 3, p, p),
        v + "embeddings.patch_embedding.bias": _randn(g, c)})
    for i in range(layers):
        lp = f"{v}encoder.layers.{i}."
        for name, shape in (("norm1", (c,)), ("norm2", (c,)),
                            ("attn.qkv", (3 * c, c)), ("attn.proj", (c, c)),
                            ("mlp.fc1", (2 * c, c)), ("mlp.fc2", (c, 2 * c))):
            sd[lp + name + ".weight"] = _randn(g, *shape)
            sd[lp + name + ".bias"] = _randn(g, shape[0])
        sd[lp + "ls1"], sd[lp + "ls2"] = _randn(g, c), _randn(g, c)
    for name, shape in (("mlp1.0", (4 * c,)), ("mlp1.1", (32, 4 * c)),
                        ("mlp1.3", (32, 32))):
        sd[name + ".weight"], sd[name + ".bias"] = (_randn(g, *shape),
                                                    _randn(g, shape[0]))
    save_file({k: t.to(torch.bfloat16).contiguous() for k, t in sd.items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "internvl_chat",
                   "llm_config": {"architectures": ["Qwen2ForCausalLM"],
                                  **LLM_KW, "tie_word_embeddings": True},
                   "vision_config": dict(
                       patch_size=p, image_size=size, hidden_size=c,
                       qkv_bias=True, num_attention_heads=4,
                       intermediate_size=2 * c, qk_normalization=False,
                       num_hidden_layers=layers, norm_type="layer_norm"),
                   "downsample_ratio": 0.5, "ps_version": "v2",
                   "force_image_size": size, "template": "internvl2_5"}, f)
    write_tokenizer_dir(path, "internvl")
    return path


MINICPM_VISION = dict(hidden_size=16, intermediate_size=32,
                      num_hidden_layers=3, num_attention_heads=2,
                      image_size=112, patch_size=14)
MINICPM_AUDIO = dict(num_mel_bins=80, d_model=16, encoder_layers=2,
                     encoder_attention_heads=4, encoder_ffn_dim=32,
                     max_source_positions=1500)
MINICPM_QUERIES, MINICPM_SCALE = 4, 56         # 56^2 slices: 4 x 4 patches


def minicpm_cfg(dtype=torch.float32, **vision):
    """The port's config of ``build_minicpm_dir``'s directory; ``vision``
    overrides SigLIP's fields."""
    return tcfg.MiniCPMOConfig(
        vision=tcfg.SiglipVisionConfig(dtype=dtype,
                                       **{**MINICPM_VISION, **vision}),
        audio=tcfg.WhisperConfig(dtype=dtype, **MINICPM_AUDIO),
        llm=tcfg.Qwen2Config(**LLM_KW, tie_word_embeddings=False,
                             dtype=dtype),
        query_num=MINICPM_QUERIES, resampler_heads=1)


def minicpm_encoder_sd(cfg, g):
    """The encoders' keys of a MiniCPM-o checkpoint in their released
    shapes (SigLIP's patch conv 4-D, the resampler's packed in-projection),
    every key the port's plan reads, and those JAX leaves unread: the
    SigLIP block MiniCPM drops, Whisper's stored position table and a TTS
    tensor."""
    shapes = {k: tuple(p.shape) for k, p in
              MiniCPMOEncoder(cfg, device="meta").named_parameters()}
    ps, sd = cfg.vision.patch_size, {}
    for key, dests in minicpmo_plan(cfg).items():
        if key.startswith("llm."):
            continue
        dests = dests if isinstance(dests, list) else [dests]
        shape = shapes[dests[0][0]]
        shape = (len(dests) * shape[0], *shape[1:])
        if key.endswith("patch_embedding.weight"):
            shape = (shape[0], 3, ps, ps)
        sd[key] = _randn(g, *shape)
    last = cfg.vision.effective_layers
    for k in [k for k in sd if k.startswith("vpm.encoder.layers.0.")]:
        sd[k.replace(".0.", f".{last}.", 1)] = _randn(g, *sd[k].shape)
    sd["apm.embed_positions.weight"] = _randn(
        g, cfg.audio.max_source_positions, cfg.audio.d_model)
    sd["tts.emb_text.weight"] = _randn(g, 4, 4)
    return sd


def build_minicpm_dir(root: str, seed: int = 0) -> str:
    """A MiniCPM-o-2.6 directory in the released layout: an untied
    transformers Qwen2 under ``llm.``, SigLIP (3 blocks, of which 2 run),
    the resampler, Whisper and the audio projector (``minicpm_encoder_sd``),
    a TTS tensor, the flat config.json with ``vision_config``,
    ``audio_config`` and ``query_num``, a preprocessor_config.json with the
    slices' scale, and the family's tokenizer."""
    path = os.path.join(root, "minicpm")
    os.makedirs(path, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    sd = {"llm." + k: v for k, v in _hf_lm(False, seed).items()}
    sd.update(minicpm_encoder_sd(minicpm_cfg(), g))
    save_file({k: t.to(torch.bfloat16).contiguous() for k, t in sd.items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "minicpmo", **LLM_KW,
                   "tie_word_embeddings": False,
                   "query_num": MINICPM_QUERIES,
                   "vision_config": MINICPM_VISION,
                   "audio_config": MINICPM_AUDIO}, f)
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"slice_config": {"max_slice_nums": 9,
                                    "scale_resolution": MINICPM_SCALE}}, f)
    write_tokenizer_dir(path, "minicpm")
    return path


def _tokenizer(path, family):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(
        path, **({"use_fast": False} if family == "internvl" else {}))


def build_dirs(tmp_path_factory):
    """family -> (model, flux, mllm, proj), bf16."""
    out = {}
    root = str(tmp_path_factory.mktemp("torch_ckpt_qwenvl"))
    flux, mllm, proj, model = build_family_checkpoints(root, "qwenvl")
    _to_bf16(root)
    out["qwenvl"] = (model, flux, mllm, proj)
    for family, build, model in (
            ("internvl", build_internvl_text_dir, "x2i-internvl2.5-1b"),
            ("minicpm", build_minicpm_dir, "x2i-minicpm-o-2.6")):
        root = str(tmp_path_factory.mktemp(f"torch_ckpt_{family}"))
        flux = build_flux_dir(root)
        proj = build_proj_bin(root, in_channels=3, input_dim=32)
        _to_bf16(root)
        out[family] = (model, flux, build(root), proj)
    return out


def pipe_cache(dirs):
    """(family, quantized) -> (port pipeline, JAX pipeline), each built
    on first use."""
    cache = {}

    def get(family, quantized=False):
        key = (family, quantized)
        if key not in cache:
            model, flux, mllm, proj = dirs[family]
            kw = dict(num_steps=STEPS, height=PX, width=PX,
                      quantized=quantized)
            # qwenvl loads its tokenizer through transformers itself
            tok = None if family == "qwenvl" else _tokenizer(mllm, family)
            port = build_pipeline_from_checkpoints(
                model, flux, mllm, proj, device="cpu", tokenizer=tok, **kw)
            ref = jax_build(model, flux, mllm, proj, **kw)
            cache[key] = (port, ref)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return build_dirs(tmp_path_factory)


@pytest.fixture(scope="module")
def pipes(dirs):
    return pipe_cache(dirs)


def _jax_enc_params(ref):
    """The JAX loader's encoder tree (minicpm's lies in ``_assemble``)."""
    free = inspect.getclosurevars(ref.encoder_fn).nonlocals
    if "_assemble" in free:
        free = inspect.getclosurevars(free["_assemble"]).nonlocals
    return free["enc_params"]


def _port_ids(port, inputs, key="lm"):
    """The token ids and mask the port's LM (``key`` "vision": MiniCPM-o's
    encoder, which embeds them) sees for ``inputs``."""
    seen = []
    hook = port.encoder_fn.ctx[key].register_forward_pre_hook(
        lambda mod, args, kw: seen.append(
            (args[0], kw.get("attention_mask", args[1:2] and args[1]))),
        with_kwargs=True)
    try:
        port.encoder_fn(inputs)
    finally:
        hook.remove()
    return seen[0][0].numpy(), seen[0][1].numpy()


def _jax_ids(family, ref, inputs):
    if family == "qwenvl":
        ids, mask, *_ = inspect.getclosurevars(
            ref.encoder_fn).nonlocals["_prep"](inputs)
        return ids, mask
    tok = inspect.getclosurevars(ref.encoder_fn).nonlocals["tokenizer"]
    enc = tok(internvl2_5_prompt(task_instruction("text2image",
                                                  inputs["prompt"])),
              padding="max_length", max_length=512, truncation=True)
    return np.asarray([enc["input_ids"]]), np.asarray([enc["attention_mask"]])


@pytest.mark.parametrize("family", ["qwenvl", "internvl", "minicpm"])
def test_loaded_weights_equal_the_jax_loaders(pipes, dirs, family):
    """Every port parameter equals the JAX loader's, carried across by the
    bridge, bit for bit: FLUX, the VAE (encoder and decoder), the proj
    and the whole encoder (the vision tower, MiniCPM-o's audio encoder
    and projector, and the LM); the directories are read whole (the MLLM
    directory of MiniCPM-o less the keys JAX leaves unread: its TTS
    tensor, its dropped SigLIP block and Whisper's stored position
    table)."""
    port, ref = pipes(family)
    trees = [(port.flux, FluxTransformer2D(port.flux.cfg), ref.flux_params),
             (port.proj, Proj(port.proj.cfg), ref.proj_params)]
    enc = _jax_enc_params(ref)
    lm, vision = (port.encoder_fn.ctx[k] for k in ("lm", "vision"))
    if family == "internvl":
        trees.append((vision, InternVLEncoder(vision.cfg), enc))
        assert vision.language_model is lm
    elif family == "minicpm":
        trees.append((vision, MiniCPMOEncoder(vision.cfg), enc))
        assert vision.llm is lm
    else:
        trees.append((lm, Qwen2LM(lm.cfg), enc["language_model"]))
        trees.append((vision, QwenVisionTransformer(vision.cfg),
                      enc["visual"]))
    for got, empty, tree in trees:
        want = load_flax(empty, tree).state_dict()
        for k, v in got.state_dict().items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    want = load_flax(AutoencoderKL(port.vae.cfg), ref.vae_params
                     ).state_dict()
    assert any(k.startswith("encoder.") for k in want)
    for k, v in port.vae.state_dict().items():
        assert torch.equal(v, want[k]), k
    rep = port.load_report
    assert rep["flux"]["unread"] == [] and rep["proj"]["unread"] == []
    assert rep["vae"]["unread"] == []
    assert rep["mllm"]["unread"] == (
        _minicpm_unread(dirs["minicpm"][2]) if family == "minicpm" else [])


def test_vae_encode_matches_jax(pipes):
    """The loaded VAE's encode (the mode, and a sample on JAX's noise) on
    the fixture against the JAX loader's, both in bf16. The two round at
    other points, so the bar is JAX's own bf16 rounding: the port's
    distance from JAX's bf16 encode, at the worst element and on average,
    at most twice that of JAX's bf16 encode from its f32 encode of the
    same weights."""
    import dataclasses

    import jax
    port, ref = pipes("qwenvl")
    f32 = type(ref.vae)(dataclasses.replace(
        ref.vae.cfg, dtype=jnp.float32, param_dtype=jnp.float32))
    f32_params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        ref.vae_params)
    rng = np.random.default_rng(3)
    pixels = jnp.asarray(rng.uniform(-1, 1, (1, PX, PX, 3)), jnp.float32)
    key = jax.random.key(2)
    for rng_key in (None, key):
        want, exact = (np.asarray(vae.apply(params, pixels, rng_key,
                                            method=vae.encode), np.float32)
                       for vae, params in ((ref.vae, ref.vae_params),
                                           (f32, f32_params)))
        eps = (None if rng_key is None else torch.as_tensor(np.asarray(
            jax.random.normal(key, want.shape, jnp.float32))))
        with torch.no_grad():
            got = port.vae.encode(torch.as_tensor(np.asarray(pixels)),
                                  eps=eps).float().numpy()
        assert got.shape == want.shape == (1, PX // 8, PX // 8, 4)
        err, own = np.abs(got - want), np.abs(want - exact)
        assert err.max() <= 2 * own.max() and err.mean() <= 2 * own.mean(), (
            err.max(), own.max(), err.mean(), own.mean())


def _minicpm_unread(mllm):
    """The keys of the minicpm fixture that JAX leaves unread: the TTS
    tensor, the SigLIP block MiniCPM drops, Whisper's position table."""
    last = MINICPM_VISION["num_hidden_layers"] - 1
    return sorted(k for k in load_file(os.path.join(
        mllm, "model.safetensors")) if k.startswith(
            ("tts.", f"vpm.encoder.layers.{last}.",
             "apm.embed_positions.")))


@pytest.mark.parametrize("family", ["qwenvl", "internvl"])
def test_token_ids_and_hidden_states_match_jax(pipes, family):
    port, ref = pipes(family)
    inputs = {"prompt": PROMPTS[0], "task": "text2image"}
    ids, mask = _port_ids(port, inputs)
    want_ids, want_mask = _jax_ids(family, ref, inputs)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask.astype(int), want_mask.astype(int))
    assert 0 < mask.sum() < 512
    got = port.encoder_fn(inputs).float().numpy()
    want = np.asarray(ref.encoder_fn(inputs), np.float32)
    assert got.shape == want.shape == (1, 3, 512, port.proj.cfg.input_dim)
    assert np.abs(got - want).max() <= STACK_BAR * np.abs(want).max()


@pytest.mark.parametrize("quantized", [False, True, "w8a8"],
                         ids=["bf16", "w8", "w8a8"])
@pytest.mark.parametrize("family", ["qwenvl", "internvl"])
def test_image_matches_jax(pipes, family, quantized):
    """The same prompt and noise through both loaded pipelines, in bf16,
    in the loader's default w8 and in w8a8."""
    port, ref = pipes(family, quantized)
    mode = "w8" if quantized is True else quantized
    assert port.flux.cfg.quantized == (mode or False)
    assert any(isinstance(m, QuantLinear) for m in port.flux.modules()) \
        == bool(mode)
    noise = np.random.default_rng(3).standard_normal(
        (1, (PX // 16) ** 2, port.flux.cfg.in_channels)).astype(np.float32)
    pooled, embeds = port.encode({"prompt": PROMPTS[1]})
    got = postprocess(port._generate(
        torch.from_numpy(noise).to(torch.bfloat16), embeds, pooled, PX, PX,
        STEPS)).numpy().astype(int)
    jpooled, jembeds = ref.encode({"prompt": PROMPTS[1]})
    want = np.asarray(ref._generate_jit(
        ref.flux_params, ref.vae_params, jembeds, jpooled,
        jnp.asarray(noise, jnp.bfloat16), None, PX, PX, STEPS)).astype(int)
    assert got.shape == want.shape == (1, PX, PX, 3)
    assert np.unique(got).size > 1
    diff = np.abs(got - want)
    assert diff.max() <= IMG_MAX and diff.mean() <= IMG_MEAN, (
        diff.max(), diff.mean())


def test_minicpm_text_path_matches_the_jax_pieces(pipes, dirs):
    """The omni content through the same chat template, the JAX
    converter on the ``llm.``-stripped keys, the JAX Qwen2 LM on the JAX
    config reader's LM config."""
    port, _ = pipes("minicpm")
    _, _, mllm, _ = dirs["minicpm"]
    tok = _tokenizer(mllm, "minicpm")
    text = tok.apply_chat_template(
        [{"role": "user", "content": minicpm_omni_content(PROMPTS[0])}],
        tokenize=False, add_generation_prompt=True)
    enc = tok(text, padding="max_length", max_length=512, truncation=True)
    ids, mask = _port_ids(port, {"prompt": PROMPTS[0]}, "vision")
    np.testing.assert_array_equal(ids, [enc["input_ids"]])
    sd = load_file(os.path.join(mllm, "model.safetensors"))
    llm_sd = {k.removeprefix("llm."): v for k, v in sd.items()
              if k.startswith("llm.")}
    cfg = minicpmo_config_from_dir(
        mllm, jcfg.MODEL_REGISTRY["x2i-minicpm-o-2.6"]["mllm"]).llm
    want, _ = JQwen2(cfg).apply(
        {"params": jtm.qwen2_params_from_hf(llm_sd, cfg)},
        jnp.asarray([enc["input_ids"]]),
        jnp.asarray([enc["attention_mask"]], bool))
    want = np.asarray(want, np.float32)
    got = port.encoder_fn({"prompt": PROMPTS[0]}).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= STACK_BAR * np.abs(want).max()
    lm = port.encoder_fn.ctx["lm"]
    assert not lm.cfg.tie_word_embeddings and torch.equal(
        lm.lm_head.weight, sd["llm.lm_head.weight"])
    assert port.load_report["mllm"]["unread"] == _minicpm_unread(mllm)


@pytest.mark.parametrize("family", ["qwenvl", "internvl", "minicpm"])
def test_batched_encode_equals_serial(pipes, family):
    port, _ = pipes(family)
    reqs = [{"prompt": p, "task": "text2image"} for p in PROMPTS]
    batched = port.encoder_fn.batch(reqs)
    serial = torch.cat([port.encoder_fn(r) for r in reqs])
    assert batched.shape[0] == 2
    torch.testing.assert_close(batched, serial, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["qwenvl", "internvl", "minicpm"])
def test_chip_smoke_tokenizer_gives_the_fixture_tokenizers_ids(tmp_path,
                                                               family):
    """chip_smoke.py's byte-level tokenizer (the card's machine has no
    transformers) renders the chat template and gives the ids and masks
    of the fixture's HF tokenizer, on every family's prompt."""
    import chip_smoke
    write_tokenizer_dir(str(tmp_path), family)
    hf = _tokenizer(str(tmp_path), family)
    ours = chip_smoke.ByteTokenizer(family)
    msgs = [[{"role": "user", "content": minicpm_omni_content(p)}]
            for p in PROMPTS] + [
        [{"role": "user", "content": [{"type": "image"},
                                      {"type": "text", "text": p}]}]
        for p in ("żółw, 海龟", PROMPTS[0])]
    texts = [internvl2_5_prompt(task_instruction("text2image", p))
             for p in PROMPTS]
    for m in msgs:
        text = hf.apply_chat_template(m, tokenize=False,
                                      add_generation_prompt=True)
        assert ours.apply_chat_template(
            m, tokenize=False, add_generation_prompt=True) == text
        texts.append(text)
    # a two-turn history: the assistant's turns rendered as the HF
    # template renders them
    history = [{"role": "user", "content": "a red fox"},
               {"role": "assistant", "content": "Żółw śpi. 海龟"},
               {"role": "user", "content": "now in snow"}]
    for gen in (True, False):
        text = hf.apply_chat_template(history, tokenize=False,
                                      add_generation_prompt=gen)
        assert ours.apply_chat_template(
            history, tokenize=False, add_generation_prompt=gen) == text
        texts.append(text)
    texts.append("x" * 600)                         # truncated at 512
    kw = dict(padding="max_length", max_length=512, truncation=True)
    assert ours(texts, **kw) == dict(hf(texts, **kw))
    assert ours(texts[0], **kw) == dict(hf(texts[0], **kw))
    # decode round trips, special tokens kept or skipped (against the
    # fast tokenizer: the slow one keeps added tokens that are not in its
    # special-token list, as the fixture's ChatML markers are not)
    fast = _tokenizer(str(tmp_path), "qwenvl")
    for text in texts[-3:-1]:
        ids = ours.encode(text)
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == \
                fast.decode(ids, skip_special_tokens=skip)
        assert ours.decode(ids) == text
    assert ours.decode([ours.byte_id[0xE6], 151000]) == "\ufffd"
    assert ours.eos_token_id == (151645 if family == "qwenvl"
                                 else hf.eos_token_id)
