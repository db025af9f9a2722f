"""The port's checkpoint conversion layer (x2i_torch/convert/) against the
JAX package's (x2i_tpu/convert/) on the CPU: the safetensors reader
against the safetensors package, each converter against its JAX
counterpart on the same bf16 state dict (every port parameter equal bit
for bit to the JAX tree carried across by ``load_flax``), the config
readers on the same files, the registry field for field, M-RoPE and the
text positions, and the untied head."""

import dataclasses
import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from torch_mirrors import MirrorAutoencoderKL, MirrorFluxTransformer2D
from test_torch_params import one_thread  # noqa: F401 (autouse)
from x2i_tpu.convert import hf_config as jhf
from x2i_tpu.convert import torch_models as jtm
from x2i_tpu.convert.load import vae_params_from_diffusers
from x2i_tpu.core import config as jcfg
from x2i_tpu.data.qwen_vision import get_rope_index as jget_rope_index
from x2i_tpu.models.qwen2 import Qwen2LM as JQwen2
from x2i_tpu.models.qwen2_5_vl import mrope_tables as jmrope_tables
from x2i_torch.convert import hf_config as thf
from x2i_torch.convert import load as tload
from x2i_torch.convert import torch_models as ttm
from x2i_torch.core import config as tcfg
from x2i_torch.data.qwen_vision import get_rope_index
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.qwen2_5_vl import mrope_tables
from x2i_torch.models.vae import AutoencoderKL
from x2i_torch.params import load_flax

FLUX_KW = dict(patch_size=1, in_channels=16, num_layers=1,
               num_single_layers=2, attention_head_dim=16,
               num_attention_heads=4, joint_attention_dim=64,
               pooled_projection_dim=32, axes_dims_rope=(4, 6, 6))
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
              latent_channels=4, norm_num_groups=4)
LLM_KW = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=8)


def bf16_sd(module: torch.nn.Module, seed: int):
    """The module's state dict with every float tensor drawn anew from
    N(0, 1) and rounded to bf16, as released checkpoints are stored."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g).to(torch.bfloat16)
            for k, v in module.state_dict().items()}


def save(sd, path):
    save_file({k: v.contiguous() for k, v in sd.items()}, path)
    return path


def assert_same_params(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


# ------------------------------------------------------------- reader

READER_DTYPES = [torch.bfloat16, torch.float16, torch.float32,
                 torch.float64, torch.int8, torch.uint8, torch.int16,
                 torch.int32, torch.int64, torch.bool]


def _tensor(dtype, shape, g):
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    return torch.randint(-100 if dtype != torch.uint8 else 0, 100, shape,
                         generator=g).to(dtype)


@pytest.mark.parametrize("dtype", READER_DTYPES, ids=str)
def test_reader_matches_the_safetensors_package(tmp_path, dtype):
    """Every dtype the reader takes, at 2-D, 0-d and empty shapes and an
    odd byte count before an aligned tensor, bit for bit and in the
    order of the data."""
    g = torch.Generator().manual_seed(0)
    sd = {"a.weight": _tensor(dtype, (5, 3), g),
          "b.scalar": _tensor(dtype, (), g),
          "c.empty": _tensor(dtype, (0, 4), g),
          "d.bytes": _tensor(torch.int8, (3,), g),
          "e.after": _tensor(dtype, (7,), g)}
    path = str(tmp_path / "m.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    want = load_file(path)
    got = {k: v.clone() for k, v in tload.read_safetensors(path)}
    assert list(got) == list(tload.read_header(path)[1])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_reader_walks_shards_in_sorted_order(tmp_path):
    g = torch.Generator().manual_seed(1)
    parts = {"model-00002-of-00002.safetensors": {"z": torch.ones(2)},
             "model-00001-of-00002.safetensors": {
                 "y": _tensor(torch.bfloat16, (4, 4), g),
                 "x": _tensor(torch.float32, (3,), g)}}
    for name, sd in parts.items():
        save_file(sd, str(tmp_path / name))
    (tmp_path / "config.json").write_text("{}")
    keys = [k for k, _ in tload.load_safetensors_dir(str(tmp_path))]
    # shard 1 in the order of its data (the writer puts f32 before bf16),
    # then shard 2
    assert keys == ["x", "y", "z"]
    assert keys == tload.safetensors_keys(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        list(tload.load_safetensors_dir(str(tmp_path / "missing")))


def test_reader_refuses_truncated_files_and_other_dtypes(tmp_path):
    path = str(tmp_path / "m.safetensors")
    save_file({"w": torch.ones(64, 64)}, path)
    data = open(path, "rb").read()
    cut = str(tmp_path / "cut.safetensors")
    open(cut, "wb").write(data[:-100])
    with pytest.raises(ValueError, match="truncated"):
        list(tload.read_safetensors(cut))
    open(cut, "wb").write(data[:20])
    with pytest.raises(ValueError, match="truncated"):
        list(tload.read_safetensors(cut))
    open(cut, "wb").write(data[:5])
    with pytest.raises(ValueError, match="truncated"):
        list(tload.read_safetensors(cut))
    header = json.dumps({"w": {"dtype": "F8_E4M3", "shape": [2],
                               "data_offsets": [0, 2]}}).encode()
    open(cut, "wb").write(struct.pack("<Q", len(header)) + header + b"ab")
    with pytest.raises(ValueError, match="F8_E4M3"):
        list(tload.read_safetensors(cut))


def test_load_torch_bin(tmp_path):
    sd = {"module.a": torch.randn(3, 2).to(torch.bfloat16)}
    torch.save(sd, tmp_path / "p.bin")
    got = tload.load_torch_bin(str(tmp_path / "p.bin"))
    assert got.keys() == sd.keys() and torch.equal(got["module.a"],
                                                   sd["module.a"])


# ---------------------------------------------------------- converters

@pytest.mark.parametrize("guidance", [False, True])
def test_flux_plan_matches_jax_converter(tmp_path, guidance):
    """diffusers names, the half-rope permutation of the q/k rows, their
    biases and the qk-norm scales: the port's plan gives the parameters of
    the JAX converter's tree (``flux_params_from_diffusers``, then the
    bridge), bit for bit."""
    mirror = MirrorFluxTransformer2D(**FLUX_KW, guidance_embeds=guidance,
                                     time_embed_channels=256)
    sd = bf16_sd(mirror, 3)
    path = save(sd, str(tmp_path / "t.safetensors"))
    tc = tcfg.FluxConfig(**FLUX_KW, guidance_embeds=guidance)
    jc = jcfg.FluxConfig(**FLUX_KW, guidance_embeds=guidance)
    got = ttm.fill_module(FluxTransformer2D(tc), tload.read_safetensors(path),
                          ttm.flux_plan(tc))
    assert got["tensors"] == len(sd) and got["unread"] == []
    ported = FluxTransformer2D(tc)
    ttm.fill_module(ported, tload.read_safetensors(path), ttm.flux_plan(tc))
    bridged = load_flax(FluxTransformer2D(tc),
                        jtm.flux_params_from_diffusers(sd, jc))
    assert_same_params(ported, bridged)
    # the permutation moved rows: q's first head starts with old rows 0, 2
    w = sd["transformer_blocks.0.attn.to_q.weight"]
    assert torch.equal(ported.double_blocks[0].img_q.weight[:2], w[[0, 2]])


def test_vae_plan_matches_jax_converter(tmp_path):
    mirror = MirrorAutoencoderKL(**VAE_KW)
    sd = bf16_sd(mirror, 4)
    path = save(sd, str(tmp_path / "v.safetensors"))
    tc = tcfg.VAEConfig(**VAE_KW)
    ported = AutoencoderKL(tc)
    rep = ttm.fill_module(ported, tload.read_safetensors(path),
                          ttm.vae_plan(tc))
    assert rep["unread"] == [] and rep["tensors"] == len(sd)
    tree = vae_params_from_diffusers(sd, jcfg.VAEConfig(**VAE_KW))
    bridged = load_flax(AutoencoderKL(tc), tree)
    assert_same_params(ported, bridged)
    assert any(k.startswith("encoder.") for k in ported.state_dict())
    # every key is read: one outside the plan raises
    path = save(dict(sd, **{"quant_conv.weight": torch.ones(8, 8, 1, 1)}),
                str(tmp_path / "x.safetensors"))
    with pytest.raises(KeyError, match="quant_conv.weight"):
        ttm.fill_module(AutoencoderKL(tc), tload.read_safetensors(path),
                        ttm.vae_plan(tc))


def _hf_qwen2(tied: bool, seed: int):
    from transformers import Qwen2Config as HFCfg
    from transformers import Qwen2ForCausalLM
    torch.manual_seed(seed)
    lm = Qwen2ForCausalLM(HFCfg(**LLM_KW, tie_word_embeddings=tied))
    sd = bf16_sd(lm, seed)
    if tied:
        sd.pop("lm_head.weight")
    return sd


# (model, HF layout prefix of the LM's keys, of its head, a key of the
# family's other modules)
LAYOUTS = {
    "internvl": ("x2i-internvl2.5-1b", "language_model.model.",
                 "language_model.lm_head.weight", "vision_model.x"),
    "qwenvl-new": ("x2i-qwenvl2.5-3b", "model.language_model.",
                   "lm_head.weight", "model.visual.x"),
    "qwenvl-old": ("x2i-qwenvl2.5-7b", "model.", "lm_head.weight",
                   "visual.x"),
    "minicpm": ("x2i-minicpm-o-2.6", "llm.model.", "llm.lm_head.weight",
                "tts.x"),
}


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_qwen2_plan_matches_jax_converter(tmp_path, layout, tied):
    """Each family's key layout, as the JAX loaders strip it, through
    ``qwen2_params_from_hf``: the same LM bit for bit. A tied checkpoint's
    head stays unread and named; so do MiniCPM-o's TTS modules, while
    the vision keys of the two families with a tower are read (by the
    encoder's plan, tests/test_torch_internvl.py and
    test_torch_qwen_vision.py), so the LM's alone refuses them."""
    model, body, head, other = LAYOUTS[layout]
    sd = _hf_qwen2(tied, 5)
    hf = {(head if k == "lm_head.weight" else body
           + k.removeprefix("model.")): v for k, v in sd.items()}
    hf[other] = torch.ones(3, dtype=torch.bfloat16)
    if tied:                           # a released tied head, unread
        hf[head] = sd["model.embed_tokens.weight"].clone()
    save(hf, str(tmp_path / "model.safetensors"))
    tc = tcfg.Qwen2Config(**LLM_KW, tie_word_embeddings=tied)
    b, h, off_path = tload._lm_layout(model, str(tmp_path), tc)
    assert (b, h) == (body, head)
    assert off_path(other) == (layout == "minicpm")
    ported = Qwen2LM(tc)
    keys = ([] if off_path(other) else [other])
    tensors = [(k, v) for k, v in tload.load_safetensors_dir(str(tmp_path))
               if k not in keys]
    rep = ttm.fill_module(ported, tensors, ttm.qwen2_plan(tc, body, head),
                          off_path)
    assert rep["unread"] == sorted(
        ([] if keys else [other]) + ([head] if tied else []))
    jc = jcfg.Qwen2Config(**LLM_KW, tie_word_embeddings=tied)
    bridged = load_flax(Qwen2LM(tc), jtm.qwen2_params_from_hf(sd, jc))
    assert_same_params(ported, bridged)
    assert hasattr(ported, "lm_head") != tied
    if keys:
        with pytest.raises(KeyError, match="not a tensor"):
            ttm.fill_module(Qwen2LM(tc),
                            tload.load_safetensors_dir(str(tmp_path)),
                            ttm.qwen2_plan(tc, body, head), off_path)


def test_fill_module_refuses_what_does_not_fit():
    tc = tcfg.Qwen2Config(**LLM_KW)
    sd = _hf_qwen2(True, 6)
    plan = ttm.qwen2_plan(tc)
    with pytest.raises(KeyError, match="lacks"):
        ttm.fill_module(Qwen2LM(tc), list(sd.items())[1:], plan)
    with pytest.raises(KeyError, match="not a tensor"):
        ttm.fill_module(Qwen2LM(tc), [*sd.items(), ("extra", sd["model.norm"
                                                               ".weight"])],
                        plan)
    with pytest.raises(ValueError, match="does not fit"):
        ttm.fill_module(Qwen2LM(tc), [(k, v[:1] if k == "model.norm.weight"
                                       else v) for k, v in sd.items()], plan)
    with pytest.raises(KeyError, match="unfilled"):
        ttm.fill_module(Qwen2LM(dataclasses.replace(
            tc, tie_word_embeddings=False)), sd.items(), plan)


def _proj_sd(form: str, seed: int):
    g = torch.Generator().manual_seed(seed)
    c, h, d1, d0 = 5, 24, 40, 16
    sd = {}
    if form == "scale":
        sd["cha_scale"] = torch.randn(1, c, 1, 1, generator=g)
    elif form == "conv":
        sd["conv.weight"] = torch.randn(1, c, 3, 3, generator=g)
        sd["conv.bias"] = torch.randn(1, generator=g)
    sd.update({"mlp.layernorm.weight": torch.randn(h, generator=g),
               "mlp.layernorm.bias": torch.randn(h, generator=g),
               "mlp.projector.0.weight": torch.randn(d1, h, generator=g),
               "mlp.projector.2.weight": torch.randn(d1, d1, generator=g),
               "mlp.fc.1.weight": torch.randn(d0, d1, generator=g),
               "mlp.fc.1.bias": torch.randn(d0, generator=g)})
    return {"module." + k: v.to(torch.bfloat16) for k, v in sd.items()}


@pytest.mark.parametrize("form", ["scale", "conv", "mean"])
def test_proj_plan_matches_jax_converter(tmp_path, form):
    torch.save(_proj_sd(form, 7), tmp_path / "p.bin")
    sd = tload.load_torch_bin(str(tmp_path / "p.bin"))
    base_t = tcfg.ProjConfig(use_cnn=form != "mean")
    base_j = jcfg.ProjConfig(use_cnn=form != "mean")
    tc = thf.proj_config_from_sd(sd, base_t)
    jc = jhf.proj_config_from_sd(sd, base_j)
    assert _common(tc, jc)
    stripped = {k.removeprefix("module."): v for k, v in sd.items()}
    ported = Proj(tc)
    ttm.fill_module(ported, stripped.items(), ttm.proj_plan(tc))
    bridged = load_flax(Proj(tc), jtm.proj_params_from_reference(sd, jc))
    assert_same_params(ported, bridged)


# -------------------------------------------------------- config readers

# JAX fields the port's configs do not have: sharding, scan and remat
# devices, the Pallas switch (``attention_impl`` in the port), the
# separate parameter dtype, the decode side's quantized LM, the VAE
# encoder's input channels, the prompt length of the generation config
JAX_ONLY = {"param_dtype", "use_pallas_attention", "single_scan_chunks",
            "rope_layout", "quantized", "in_channels"}


def _common(t, j) -> bool:
    """t and j agree on every field they share but the dtypes; the JAX
    fields the port lacks are the known ones."""
    tf = {f.name for f in dataclasses.fields(t)}
    jf = {f.name for f in dataclasses.fields(j)}
    extra = jf - tf
    assert extra <= JAX_ONLY | {"vision"}, extra
    for n in sorted((tf & jf) - {"dtype"}):
        tv, jv = getattr(t, n), getattr(j, n)
        if dataclasses.is_dataclass(tv):
            assert _common(tv, jv), n
        else:
            assert tv == jv, (n, tv, jv)
    return True


def _write(path, d):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f)


def test_flux_vae_scheduler_readers_match_jax(tmp_path):
    root = str(tmp_path)
    _write(f"{root}/transformer/config.json",
           {**FLUX_KW, "guidance_embeds": True,
            "axes_dims_rope": list(FLUX_KW["axes_dims_rope"])})
    _write(f"{root}/vae/config.json",
           {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [8, 8, 16, 16], "layers_per_block": 1,
            "norm_num_groups": 4, "scaling_factor": 0.5,
            "shift_factor": None, "mid_block_add_attention": False})
    _write(f"{root}/scheduler/scheduler_config.json",
           {"num_train_timesteps": 1000, "shift": 3.0,
            "use_dynamic_shifting": True, "base_shift": 0.5,
            "max_shift": 1.15, "base_image_seq_len": 256,
            "max_image_seq_len": 4096})
    spec = tcfg.MODEL_REGISTRY["x2i-internvl2.5-1b"]
    jspec = jcfg.MODEL_REGISTRY["x2i-internvl2.5-1b"]
    assert _common(thf.flux_config_from_dir(root, spec.flux),
                   jhf.flux_config_from_dir(root, jspec["flux"]))
    # the reader carries the base's ring_sequence, as JAX's does
    ring = dataclasses.replace(spec.flux, ring_sequence=True)
    assert _common(thf.flux_config_from_dir(root, ring),
                   jhf.flux_config_from_dir(root, dataclasses.replace(
                       jspec["flux"], ring_sequence=True)))
    assert thf.flux_config_from_dir(root, ring).ring_sequence
    vae = thf.vae_config_from_dir(root)
    assert _common(vae, jhf.vae_config_from_dir(root))
    assert vae.shift_factor == 0.0 and not vae.use_mid_attention
    assert _common(thf.scheduler_config_from_dir(root),
                   jhf.scheduler_config_from_dir(root))
    empty = str(tmp_path / "none")
    assert thf.flux_config_from_dir(empty) is None
    assert thf.vae_config_from_dir(empty) is None
    assert thf.scheduler_config_from_dir(empty) is None


@pytest.mark.parametrize("nested", [False, True])
def test_qwenvl_reader_matches_jax(tmp_path, nested):
    text = {**LLM_KW, "rope_theta": 5e5, "tie_word_embeddings": False,
            "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
            "rope_scaling": {"type": "mrope", "mrope_section": [1, 1, 2]}}
    d = {"image_token_id": 7, "video_token_id": 8,
         "vision_start_token_id": 9, "vision_config": {"depth": 2}}
    d.update({"text_config": text} if nested else text)
    _write(f"{tmp_path}/config.json", d)
    base_t = tcfg.MODEL_REGISTRY["x2i-qwenvl2.5-7b"].llm
    base_j = jcfg.MODEL_REGISTRY["x2i-qwenvl2.5-7b"]["mllm"]
    got = thf.qwenvl_config_from_dir(str(tmp_path), base_t)
    want = jhf.qwenvl_config_from_dir(str(tmp_path), base_j)
    assert _common(got, want)
    assert got.mrope_section == (1, 1, 2) and got.llm.head_dim == 8


def test_internvl_and_minicpmo_readers_match_jax(tmp_path):
    iv, mc = tmp_path / "internvl", tmp_path / "minicpm"
    _write(f"{iv}/config.json", {
        "llm_config": {**LLM_KW, "head_dim": None, "rope_theta": 1e4},
        "vision_config": {"hidden_size": 32}, "downsample_ratio": 0.5})
    _write(f"{mc}/config.json", {**LLM_KW, "tie_word_embeddings": False,
                                 "vision_config": {}, "query_num": 4})
    jbase = jcfg.MODEL_REGISTRY["x2i-internvl2.5-4b"]["mllm"]
    got = thf.internvl_llm_config_from_dir(
        str(iv), tcfg.MODEL_REGISTRY["x2i-internvl2.5-4b"].llm)
    assert _common(got, jhf.internvl_config_from_dir(str(iv), jbase).llm)
    assert got.head_dim == 8                 # hidden / heads when null
    got = thf.minicpmo_config_from_dir(
        str(mc), tcfg.MODEL_REGISTRY["x2i-minicpm-o-2.6"].llm).llm
    want = jhf.minicpmo_config_from_dir(
        str(mc), jcfg.MODEL_REGISTRY["x2i-minicpm-o-2.6"]["mllm"]).llm
    assert _common(got, want) and not got.tie_word_embeddings


# ------------------------------------------------------------ registry

@pytest.mark.parametrize("name", list(jcfg.MODEL_REGISTRY))
def test_registry_entry_matches_jax(name):
    """LM, proj, DiT and scheduler of each of the six entries (the
    InternVL entries' LM is the JAX InternVLConfig's ``llm``); the VAE is
    the JAX loader's default."""
    t, j = tcfg.MODEL_REGISTRY[name], jcfg.MODEL_REGISTRY[name]
    mllm = j["mllm"]
    assert _common(t.llm, getattr(mllm, "llm", mllm))
    assert _common(t.proj, j["proj"])
    assert _common(t.flux, j["flux"])
    assert _common(t.scheduler, j["scheduler"])
    assert _common(t.vae, jcfg.VAEConfig())


def test_registries_have_the_jax_entries():
    assert list(tcfg.MODEL_REGISTRY) == list(jcfg.MODEL_REGISTRY)
    assert list(tcfg.PROJ_REGISTRY) == list(jcfg.PROJ_REGISTRY)
    for name in jcfg.PROJ_REGISTRY:
        assert _common(tcfg.PROJ_REGISTRY[name], jcfg.PROJ_REGISTRY[name])


# ------------------------------------------------- M-RoPE and positions

def _masks():
    """Right-padded, left-padded and unpadded rows."""
    s = 24
    mask = np.ones((3, s), np.int64)
    mask[0, 17:] = 0
    mask[1, :9] = 0
    return mask


def test_get_rope_index_text_matches_jax():
    mask = _masks()
    ids = np.random.default_rng(8).integers(0, 50, mask.shape)
    got, got_d = get_rope_index(ids, attention_mask=mask)
    want, want_d = jget_rope_index(ids, attention_mask=mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_d, want_d)
    assert (got[:, 0, 17:] == 1).all() and (got[:, 1, :9] == 1).all()
    # an image grid with no image in the prompt leaves text positions
    # (tests/test_torch_vision_data.py holds prompts with media)
    grid = np.array([[1, 4, 4]])
    for a, b in zip(get_rope_index(ids, grid, attention_mask=mask),
                    jget_rope_index(ids, grid, attention_mask=mask)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("section", [(16, 24, 24), (1, 2, 3)])
def test_mrope_tables_match_jax(section):
    """The tables, and what the port's rotation reads of them: the first
    half, which the second half mirrors."""
    d = 2 * sum(section)
    rng = np.random.default_rng(9)
    pos = rng.integers(0, 600, (3, 2, 12))
    cos, sin = mrope_tables(torch.from_numpy(pos), d, 1e6, section)
    jc, js = jmrope_tables(jnp.asarray(pos), d, 1e6, section)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), rtol=0,
                               atol=2e-6)
    assert torch.equal(cos[..., :d // 2], cos[..., d // 2:])
    assert torch.equal(sin[..., :d // 2], sin[..., d // 2:])


def _lm_pair(tied: bool, seed: int):
    """A float32 port LM and the JAX params of the same weights (Linear
    weights at std 1/sqrt(fan_in), norm scales 1 + N(0, 0.1^2))."""
    sd = {k: v.float() / (v.shape[1] ** 0.5 if k.endswith("proj.weight")
                          or k == "lm_head.weight" else 1.0)
          for k, v in _hf_qwen2(tied, seed).items()}
    sd = {k: 1.0 + 0.1 * v if "norm" in k else v for k, v in sd.items()}
    tc = tcfg.Qwen2Config(**LLM_KW, tie_word_embeddings=tied,
                          dtype=torch.float32, attention_impl="plain")
    jc = jcfg.Qwen2Config(**LLM_KW, tie_word_embeddings=tied,
                          dtype=jnp.float32, param_dtype=jnp.float32,
                          use_pallas_attention=False)
    lm = Qwen2LM(tc)
    ttm.fill_module(lm, sd.items(), ttm.qwen2_plan(tc))
    return lm, JQwen2(jc), {"params": jtm.qwen2_params_from_hf(sd, jc)}


@pytest.mark.parametrize("route", ["position_ids", "rope"])
def test_lm_position_arguments_match_jax(route):
    mask = _masks()
    rng = np.random.default_rng(10)
    ids = rng.integers(0, LLM_KW["vocab_size"], mask.shape)
    lm, jlm, params = _lm_pair(True, 11)
    if route == "position_ids":
        pos = rng.integers(0, 40, mask.shape)
        kw_t = dict(position_ids=torch.from_numpy(pos))
        kw_j = dict(position_ids=jnp.asarray(pos))
    else:
        pos3d, _ = get_rope_index(ids, attention_mask=mask)
        cos, sin = mrope_tables(torch.from_numpy(pos3d), 8, 1e6, (1, 1, 2))
        kw_t = dict(rope=(cos, sin))
        kw_j = dict(rope=(jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())))
    with torch.inference_mode():
        got, _ = lm(torch.from_numpy(ids), torch.from_numpy(mask).bool(),
                    **kw_t)
    want, _ = jlm.apply(params, jnp.asarray(ids), jnp.asarray(mask, bool),
                        **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_logits_match_jax(tied):
    lm, jlm, params = _lm_pair(tied, 12)
    h = np.random.default_rng(12).standard_normal((2, 5, 32)).astype(
        np.float32)
    with torch.inference_mode():
        got = lm.logits(torch.from_numpy(h)).numpy()
    want = np.asarray(jlm.apply(params, jnp.asarray(h), method=jlm.logits))
    assert got.shape == (2, 5, LLM_KW["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
