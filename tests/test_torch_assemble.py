"""The phase-1 trainer assembled from checkpoint directories
(``x2i_torch/train/assemble.py``) and the teachers' and scorer's plans,
on the CPU against the JAX package.

* The T5, CLIP-text and CLIP-vision plans on tiny random HF
  ``T5EncoderModel`` / ``CLIPModel`` state dicts against JAX's converters
  and modules on the same dict: f32, 2e-5; the keys each leaves unread;
  the config readers.
* ``assemble_distill`` on tiny fixture directories (tests/ckpt_fixtures.py's
  Qwen2.5-VL family, tiny T5 and CLIP directories, caption shards),
  tokenizers injected (chip_smoke.py's byte-level ones): the loader's
  first batch is JAX's ``DistillDataModule``'s bit for bit; one step's
  loss and grad norm on it equal a hand-wired port trainer's on the same
  weights (carried from JAX's converted trees by the bridge) bit for bit,
  and are within 1e-4 of JAX's ``make_distill_step`` on those trees, the
  noise passed in as an array. (JAX's own ``assemble_distill`` raises on
  its first call, so it is held piece by piece.)
* The launch counts ``chip_smoke.distill_step_launches`` derives, against
  the flash wrappers' calls counted in one step of a small trainer whose
  attention takes the kernel route's plain versions.
"""

import dataclasses
import io
import json
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ckpt_fixtures import build_family_checkpoints
from x2i_tpu.convert import hf_config as jhf
from x2i_tpu.convert import load as jload
from x2i_tpu.convert import torch_models as jtm
from x2i_tpu.core import config as jcfg
from x2i_tpu.data import datamodule as jdm
from x2i_tpu.diffusion import sampling as jsamp
from x2i_tpu.models import clip as jclip
from x2i_tpu.models import t5 as jt5
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.models.proj import Proj as JProj
from x2i_tpu.models.qwen2_5_vl import Qwen2_5_VLEncoder as JQwenVL
from x2i_tpu.train import distill as jdistill
from x2i_torch.convert import hf_config as thf
from x2i_torch.convert import torch_models as ttm
from x2i_torch.core import config as tcfg
from x2i_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.qwen2_5_vl import encode_text
from x2i_torch.models.t5 import T5Encoder
from x2i_torch.ops import flash_attention as fa
from x2i_torch.params import load_flax, random_init_
from x2i_torch.train import assemble as tasm
from x2i_torch.train import harness as tharness

TOL = dict(atol=2e-5, rtol=2e-5)
MODEL = "x2i-qwenvl2.5-7b"
VOCAB = 320                       # the fixtures' byte-level vocabulary
T5_KW = dict(vocab_size=VOCAB, d_model=64, d_kv=16, d_ff=96, num_layers=2,
             num_heads=4)
CLIP_TEXT_KW = dict(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=77, eos_token_id=VOCAB - 1)
CLIP_VISION_KW = dict(hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      image_size=28, patch_size=7)
DCFG = dict(latent_height=16, latent_width=16, text_seq_len=192,
            lr_warmup_steps=1, max_train_steps=100, learning_rate=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny trainers' ops run ten times slower on torch's pool under the
    Tier-1 run's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_t5():
    from transformers import T5Config, T5EncoderModel
    torch.manual_seed(1)
    return T5EncoderModel(T5Config(
        **T5_KW, feed_forward_proj="gated-gelu", dropout_rate=0.0)).eval()


def _hf_clip():
    from transformers import CLIPConfig, CLIPModel
    torch.manual_seed(2)
    cfg = CLIPConfig(
        text_config=dict(CLIP_TEXT_KW, bos_token_id=VOCAB - 2,
                         hidden_act="quick_gelu"),
        vision_config=dict(CLIP_VISION_KW, hidden_act="quick_gelu"),
        projection_dim=16)
    cfg._attn_implementation = "eager"
    return CLIPModel(cfg).eval()


def _f32(cfg, **changes):
    """A JAX config in f32 (its nested configs too)."""
    nested = {f.name: _f32(getattr(cfg, f.name))
              for f in dataclasses.fields(cfg)
              if dataclasses.is_dataclass(getattr(cfg, f.name))}
    dt = {k: jnp.float32 for k in ("dtype", "param_dtype")
          if hasattr(cfg, k)}
    return dataclasses.replace(cfg, **nested, **dt, **changes)


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------- plans

def test_t5_plan_matches_jax_converter():
    """Block 0's relative bias serves every layer; the encoder's tied
    ``embed_tokens`` and a later block's bias table (added here, as some
    checkpoints carry one) are the unread keys."""
    sd = _sd(_hf_t5())
    extra = "encoder.block.1.layer.0.SelfAttention.relative_attention_bias."\
            "weight"
    sd[extra] = torch.randn(32, 4)
    cfg = tcfg.T5Config(**T5_KW, dtype=torch.float32)
    port = T5Encoder(cfg)
    rep = ttm.fill_module(port, sd.items(), ttm.t5_plan(cfg),
                          ttm.t5_off_path)
    assert rep["unread"] == sorted(["encoder.embed_tokens.weight", extra])
    jc = jt5.T5Config(**T5_KW, dtype=jnp.float32, param_dtype=jnp.float32)
    tree = {"params": jtm.t5_params_from_hf(sd, 2)}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (2, 12))
    mask = np.arange(12)[None] < np.array([[12], [7]])
    want = jax.jit(jt5.T5Encoder(jc).apply)(tree, ids, mask)
    with torch.no_grad():
        got = port(torch.as_tensor(ids), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bridged = load_flax(T5Encoder(cfg), tree)
    for (name, p), q in zip(port.state_dict().items(),
                            bridged.state_dict().values()):
        assert torch.equal(p, q), name


def test_clip_plans_match_jax_converters():
    """The text tower read from a whole CLIPModel (the vision tower, the
    projections and logit_scale unread) and the vision tower, each
    against JAX's converter and module; ``clip_plan`` reads both towers
    and the projections, logit_scale alone unread."""
    sd = _sd(_hf_clip())
    tc = tcfg.CLIPTextConfig(**CLIP_TEXT_KW, dtype=torch.float32)
    vc = tcfg.CLIPVisionConfig(**CLIP_VISION_KW, projection_dim=16,
                               dtype=torch.float32)
    text = CLIPTextEncoder(tc)
    rep = ttm.fill_module(text, sd.items(), ttm.clip_text_plan(tc),
                          ttm.clip_off_path(text_only=True))
    assert "logit_scale" in rep["unread"] and not any(
        k.startswith("text_model.") for k in rep["unread"]
        if not k.endswith("position_ids"))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB - 1, (2, 77))
    ids[:, 20] = VOCAB - 1
    jt = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(
        **CLIP_TEXT_KW, dtype=jnp.float32, param_dtype=jnp.float32))
    want = jax.jit(jt.apply)({"params": jtm.clip_params_from_hf(sd, 2)},
                             ids)
    with torch.no_grad():
        got = text(torch.as_tensor(ids))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    vision = CLIPVisionEncoder(vc)
    vplan = ttm.clip_vision_plan(vc)
    ttm.fill_module(vision, ((k, v) for k, v in sd.items() if k in vplan),
                    vplan)
    px = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    jv = jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(
        **CLIP_VISION_KW, dtype=jnp.float32, param_dtype=jnp.float32))
    want = jax.jit(jv.apply)(
        {"params": jtm.clip_vision_params_from_hf(sd, 2)}, px)
    with torch.no_grad():
        got = vision(torch.from_numpy(px))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    from x2i_torch.models.clip import CLIPModel
    whole = CLIPModel(tc, vc)
    rep = ttm.fill_module(whole, sd.items(), ttm.clip_plan(tc, vc),
                          ttm.clip_off_path(text_only=False))
    assert [k for k in rep["unread"]
            if not k.endswith("position_ids")] == ["logit_scale"]
    assert torch.equal(whole.visual_projection.weight,
                       sd["visual_projection.weight"])


def test_config_readers(tmp_path):
    """T5's and CLIP's config.json as transformers writes them; the
    defaults without one; the legacy CLIP eos 2 pools at the last id."""
    _hf_t5().config.save_pretrained(str(tmp_path / "t5"))
    assert thf.t5_config_from_dir(str(tmp_path / "t5")) == tcfg.T5Config(
        **T5_KW)
    assert thf.t5_config_from_dir(str(tmp_path)) == tcfg.T5Config()
    _hf_clip().config.save_pretrained(str(tmp_path / "clip"))
    text, vision = thf.clip_configs_from_dir(str(tmp_path / "clip"),
                                             torch.float32)
    assert text == tcfg.CLIPTextConfig(**CLIP_TEXT_KW, dtype=torch.float32)
    assert vision == tcfg.CLIPVisionConfig(
        **CLIP_VISION_KW, projection_dim=16, dtype=torch.float32)
    assert thf.clip_configs_from_dir(str(tmp_path)) == (
        tcfg.CLIPTextConfig(), tcfg.CLIPVisionConfig())
    os.makedirs(tmp_path / "legacy")
    (tmp_path / "legacy" / "config.json").write_text(json.dumps(
        {"model_type": "clip_text_model", "eos_token_id": 2,
         "vocab_size": 49408}))
    assert thf.clip_configs_from_dir(str(tmp_path / "legacy"))[
        0].eos_token_id == 49407


# ---------------------------------------------------------------- assemble

def _write_shards(root):
    paths = []
    for j in range(2):
        path = os.path.join(root, f"cap-{j}.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(4 * j, 4 * j + 4):
                cap = f"a small red house #{i} by the sea"
                for ext, data in (("json", json.dumps(
                        {"caption_en": cap, "caption_zh": "房子"}).encode()),
                        ("txt", cap.encode())):
                    info = tarfile.TarInfo(f"{i:05d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
        paths.append(path)
    return os.path.join(root, "cap-{0..1}.tar")


def _tokenizers():
    return (chip_smoke.ByteTokenizer("qwenvl"),
            chip_smoke.EndTokenizer(end=1, pad=0),
            chip_smoke.EndTokenizer(end=VOCAB - 1, pad=VOCAB - 1))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("assemble"))
    flux, mllm, proj, model = build_family_checkpoints(root, "qwenvl")
    assert model == MODEL
    t5, clip = os.path.join(root, "t5"), os.path.join(root, "clip")
    _hf_t5().save_pretrained(t5)
    _hf_clip().save_pretrained(clip)
    return dict(flux=flux, mllm=mllm, proj=proj, t5=t5, clip=clip,
                urls=_write_shards(root))


@pytest.fixture(scope="module")
def assembled(ckpt):
    dcfg = tcfg.DistillConfig(**DCFG)
    step, state, parts, loader = tasm.assemble_distill(
        MODEL, ckpt["flux"], ckpt["mllm"], ckpt["t5"], ckpt["clip"],
        ckpt["urls"], dcfg=dcfg, proj_ckpt=ckpt["proj"], device="cpu",
        tokenizers=_tokenizers(), dtype=torch.float32)
    batch = next(iter(loader()))
    return step, state, parts, batch, dcfg


def _latents(dcfg):
    """The noise JAX's student draws from key(0), packed."""
    lat = jax.random.normal(jax.random.key(0),
                            (1, 4, dcfg.latent_height, dcfg.latent_width),
                            jnp.float32)
    return np.asarray(jsamp.pack_latents(lat)), jax.random.key(0)


def _jax_trainer(ckpt, dcfg):
    """JAX's trainer by hand, as its ``assemble_distill`` wires it, on its
    converters' trees in f32 (with the directory's DiT config)."""
    reg = jcfg.MODEL_REGISTRY[MODEL]
    flux_cfg = _f32(jhf.flux_config_from_dir(ckpt["flux"], reg["flux"]),
                    rope_in_kernel=False)
    vl_cfg = _f32(jhf.qwenvl_config_from_dir(ckpt["mllm"], reg["mllm"]))
    proj_sd = jload.load_torch_bin(ckpt["proj"])
    proj_cfg = _f32(jhf.proj_config_from_sd(proj_sd, reg["proj"]))
    t5_cfg = jt5.T5Config(**T5_KW, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    clip_cfg = jclip.CLIPTextConfig(**CLIP_TEXT_KW, dtype=jnp.float32,
                                    param_dtype=jnp.float32)
    trees = {
        "flux": {"params": jtm.flux_params_from_diffusers(
            jload.load_safetensors_dir(os.path.join(ckpt["flux"],
                                                    "transformer")),
            flux_cfg)},
        "mllm": {"params": jload.qwen2_5_vl_params_from_hf(
            jload.load_safetensors_dir(ckpt["mllm"]), vl_cfg.llm,
            vision_depth=vl_cfg.vision.depth)},
        "t5": {"params": jtm.t5_params_from_hf(
            jload.load_safetensors_dir(ckpt["t5"]), 2)},
        "clip": {"params": jtm.clip_params_from_hf(
            jload.load_safetensors_dir(ckpt["clip"]), 2)},
        "proj": {"params": jtm.proj_params_from_reference(proj_sd,
                                                          proj_cfg)}}
    enc, t5, clip = (JQwenVL(vl_cfg), jt5.T5Encoder(t5_cfg),
                     jclip.CLIPTextEncoder(clip_cfg))
    jtrees = jax.tree_util.tree_map(jnp.asarray, trees)

    def teacher_text_fn(b):
        seq = t5.apply(jtrees["t5"], b["t5_ids"], b["t5_mask"])
        return seq, clip.apply(jtrees["clip"], b["clip_ids"])[1]

    def student_states_fn(b):
        mask = b["mllm_mask"].astype(jnp.int32)
        pos = jnp.clip(jnp.cumsum(mask, axis=-1) - 1, 0, None)
        pos3d = jnp.broadcast_to(pos[None], (3,) + pos.shape)
        return enc.apply(jtrees["mllm"], b["mllm_ids"], b["mllm_mask"],
                         pos3d, None)

    jdcfg = jcfg.DistillConfig(**DCFG)
    optimizer = jdistill.make_optimizer(jdcfg)
    step = jax.jit(jdistill.make_distill_step(
        JFlux(flux_cfg).apply, JProj(proj_cfg).apply, teacher_text_fn,
        student_states_fn, optimizer, flux_cfg, jdcfg))
    state = jdistill.TrainState(jtrees["proj"],
                                optimizer.init(jtrees["proj"]),
                                jnp.zeros((), jnp.int32))
    return step, state, trees, jtrees


def test_assembled_loader_and_load_report(ckpt, assembled):
    """The first batch is the JAX datamodule's on the same shards with the
    same tokenize callables, family template and seed; every key of the
    five directories read but the stated off-paths."""
    _, _, parts, batch, dcfg = assembled
    mllm_tok, t5_tok, clip_tok = _tokenizers()
    ref = jdm.DistillDataModule(
        jdm.DistillDataConfig(urls=ckpt["urls"], text_seq_len=192),
        mllm_tokenize=tasm.hf_tokenize(mllm_tok, 192),
        t5_tokenize=tasm.hf_tokenize(t5_tok, 192),
        clip_tokenize=tasm.hf_tokenize(clip_tok, 77, with_mask=False),
        chat_template=jdm.family_chat_template(MODEL, mllm_tok))
    want = next(iter(ref.train_loader()))
    assert batch.keys() == want.keys()
    for k in want:
        assert batch[k].dtype == torch.from_numpy(want[k]).dtype, k
        np.testing.assert_array_equal(batch[k].numpy(), want[k])
    assert batch["mllm_ids"][0, 0] == mllm_tok.special["<|im_start|>"]
    rep = parts["load_report"]
    assert set(rep) == {"flux", "mllm", "t5", "clip", "proj"}
    assert rep["flux"]["unread"] == rep["proj"]["unread"] == []
    assert rep["t5"]["unread"] == []               # saved without the tie
    assert {k.split(".")[0] for k in rep["clip"]["unread"]} == {
        "vision_model", "visual_projection", "text_projection",
        "logit_scale"}
    assert parts["flux"].cfg.remat and not parts["flux"].cfg.fused_glue


def test_assembled_step_matches_hand_wired_and_jax(ckpt, assembled):
    step, state, parts, batch, dcfg = assembled
    lat, key = _latents(dcfg)
    jstep, jstate, trees, jtrees = _jax_trainer(ckpt, dcfg)

    # the port's trainer by hand: the bridge's copies of JAX's trees
    flux_cfg = dataclasses.replace(parts["flux"].cfg)
    f32 = torch.float32
    flux = load_flax(FluxTransformer2D(flux_cfg), trees["flux"])
    t5 = load_flax(T5Encoder(tcfg.T5Config(**T5_KW, dtype=f32)),
                   trees["t5"])
    clip = load_flax(CLIPTextEncoder(tcfg.CLIPTextConfig(
        **CLIP_TEXT_KW, dtype=f32)), trees["clip"])
    proj = load_flax(Proj(parts["proj"].cfg), trees["proj"])
    tvl = parts["vl_cfg"]
    lm = load_flax(Qwen2LM(tvl.llm), trees["mllm"]["params"][
        "language_model"])

    def states(b):
        pos = (b["mllm_mask"].long().cumsum(-1) - 1).clamp_min(0)
        return encode_text(lm, tvl, b["mllm_ids"], b["mllm_mask"],
                           pos[None].expand(3, -1, -1))

    (teacher_fn, student_fn), hstate, _ = tharness.wire_distill(
        flux, lm, t5, clip, proj, None, flux_cfg, dcfg, split=True,
        slim_handoff=True, student_states_fn=states)
    noise = torch.from_numpy(lat.copy())
    _, m = step(state, batch, noise)
    _, hm = student_fn(hstate, batch, teacher_fn(batch, noise), noise)
    for k in ("loss", "grad_norm"):
        assert torch.equal(m[k], hm[k]), k

    jbatch = {k: v.numpy() for k, v in batch.items()}
    _, jm = jstep(jstate, jtrees["flux"], jbatch, key)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-4,
                                   rtol=1e-4)
    assert float(m["grad_norm"]) > 0


# ------------------------------------------------------ launch counts

def test_distill_launches_count_the_wrappers_calls(monkeypatch):
    """chip_smoke.distill_step_launches(1, 2, lm_layers=2) against one
    step of a small trainer (a 1 + 2-block DiT and a 2-layer LM at head
    size 64, 256 image + 128 text tokens: multiples of 128, as the card's
    4096 + 512, so that the routes are the card's) whose
    attention takes the kernel route, each flash wrapper's call counted
    where its plain version runs, under the name its CUDA launch counts:
    the lse forward, the exact body (a mask or causal) or the pipelined
    one."""
    calls = dict(chip_smoke.NO_LAUNCHES)
    plain = fa.flash_attention_plain

    def counted(q, k, v, kv_mask=None, causal=False, scale=None, rope=None,
                qk_norm=None, return_lse=False):
        name = ("flash_fwd_lse" if return_lse else "flash_fwd_rope"
                if rope is not None else "flash_fwd"
                if fa.is_exact(kv_mask, causal, k.shape[2])
                else "flash_fwd_pipe")
        calls[name] += 1
        return plain(q, k, v, kv_mask, causal, scale, rope, qk_norm,
                     return_lse=return_lse)

    def bwd(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
    monkeypatch.setattr(fa, "flash_bwd_dq_plain",
                        bwd("flash_bwd_dq", fa.flash_bwd_dq_plain))
    monkeypatch.setattr(fa, "flash_bwd_dkv_plain",
                        bwd("flash_bwd_dkv", fa.flash_bwd_dkv_plain))

    flux_cfg = tcfg.tiny_flux_config(
        num_layers=1, num_single_layers=2, attention_head_dim=64,
        num_attention_heads=2, axes_dims_rope=(16, 24, 24), in_channels=16,
        guidance_embeds=True, attention_impl="kernel", **tharness.TRAIN_DIT)
    lm_cfg = tcfg.tiny_qwen2_config(hidden_size=128, num_attention_heads=2,
                                    num_key_value_heads=1, head_dim=64,
                                    attention_impl="kernel")
    t5 = T5Encoder(tcfg.T5Config(vocab_size=64, d_model=64, d_kv=16,
                                 d_ff=64, num_layers=1, num_heads=4,
                                 dtype=torch.float32))
    clip = CLIPTextEncoder(tcfg.CLIPTextConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=4, eos_token_id=63,
        dtype=torch.float32))
    proj = Proj(tcfg.ProjConfig(in_channels=3, input_dim=128,
                                output_dim0=32, output_dim1=64,
                                dtype=torch.float32))
    mods = [FluxTransformer2D(flux_cfg), Qwen2LM(lm_cfg), t5, clip, proj]
    gen = torch.Generator().manual_seed(0)
    for mod in mods:
        random_init_(mod, gen)
    dcfg = tcfg.DistillConfig(**dict(DCFG, latent_height=32,
                                     latent_width=32, text_seq_len=128))
    (teacher_fn, student_fn), state, _ = tharness.wire_distill(
        *mods, None, flux_cfg, dcfg, split=True, slim_handoff=True)
    rng = np.random.default_rng(0)
    mask = np.arange(128)[None] < 100
    batch = {"t5_ids": rng.integers(0, 64, (1, 128)), "t5_mask": mask,
             "clip_ids": rng.integers(0, 63, (1, 77)),
             "mllm_ids": rng.integers(0, 512, (1, 128)), "mllm_mask": mask}
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, m = student_fn(state, batch, teacher_fn(batch, 0), 0)
    assert np.isfinite(float(m["loss"]))
    assert calls == chip_smoke.distill_step_launches(1, 2, lm_layers=2)
