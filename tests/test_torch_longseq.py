"""The long-sequence serving path of the port against the JAX package on
the CPU: the tiled VAE decode, the streamed prompt encode (the proj's
channel mix summed inside the LM's layer loop), and the tiny text->image
pipeline above ``MAX_KV_SEQ`` and ``vae_tile_px``.

Tiny float32 weights carried across by the bridge, inputs from
np.random.default_rng(seed). Tolerances: 1e-4 (summation order only);
pipeline pixels to 1e-4 of their largest magnitude and uint8 images to one
level, as the text->image slice's test holds them.
"""

import dataclasses
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import one_thread, qwen2_tree, random_tree, vae_cfgs
from x2i_tpu import pipeline as jpipe
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion.sampling import prepare_latent_image_ids
from x2i_tpu.diffusion.scheduler import FlowMatchEulerScheduler as JSched
from x2i_tpu.models import proj as jproj
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.models.qwen2 import Qwen2LM as JQwen2
from x2i_tpu.models.vae import AutoencoderKL as JVAE
from x2i_tpu.ops import flash_attention as jfa
from x2i_torch.core import config as tcfg
from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj, streaming_mix_spec
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.vae import AutoencoderKL, postprocess
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.params import load_flax
from x2i_torch.pipeline import (X2IPipeline, lm_text_encoder, resolve_device,
                                tiny_vae_config)

jattn = importlib.import_module("x2i_tpu.ops.attention")
TOL = dict(atol=1e-4, rtol=1e-4)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------- tiled VAE decode

def _vaes():
    jc, tc = vae_cfgs()
    vae = JVAE(jc)
    tree = random_tree(functools.partial(vae.init, method=vae.decode),
                       jnp.zeros((1, 4, 4, 16)))
    model = AutoencoderKL(tc)
    load_flax(model.decoder, tree["params"]["decoder"])
    return vae, tree, model


@pytest.mark.parametrize("shape", [(14, 9), (8, 13), (9, 6)])
def test_decode_tiled_matches_jax(shape):
    """Tiles of 8 latents, stride 6, 16-px blends, 48 px kept; the sides
    are no multiples of the stride, so edge tiles are smaller than a tile
    and narrower than a blend; the vertical blend comes first."""
    vae, tree, model = _vaes()
    z = np.random.default_rng(sum(shape)).standard_normal((1, *shape, 16))
    want = jax.jit(functools.partial(vae.apply, tile_latent=8,
                                     method=vae.decode_tiled))(
        tree, jnp.asarray(z, jnp.float32))
    with torch.inference_mode():
        got = model.decode_tiled(t(z), tile_latent=8)
        whole = model.decode(t(z))
    assert got.shape == (1, shape[0] * 8, shape[1] * 8, 3)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    # per-tile group-norm statistics: it is not the untiled decode
    assert np.abs(n(got) - n(whole)).max() > 1e-3


def test_decode_tiled_one_tile_is_decode():
    _, _, model = _vaes()
    z = t(np.random.default_rng(0).standard_normal((2, 8, 5, 16)))
    with torch.inference_mode():
        assert torch.equal(model.decode_tiled(z, tile_latent=8),
                           model.decode(z))


# ------------------------------------------------- streamed prompt encode

def _proj_cfgs(mode, **kw):
    kw = dict(dict(in_channels=3, input_dim=64, output_dim0=8, output_dim1=12,
                   use_scale=mode == "scale", use_cnn=mode == "cnn"), **kw)
    return (jcfg.ProjConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            tcfg.ProjConfig(dtype=torch.float32, **kw))


@pytest.mark.parametrize("mode", ["scale", "cnn", "mean"])
def test_streamed_encode_matches_jax_and_the_stack_route(mode):
    """``streaming_mix_spec`` + ``encode_premixed`` + ``Proj.mlp`` against
    the JAX package's, and against the port's own stack route
    (``Qwen2LM.__call__`` + ``Proj``), batch 2 with right-padded masks."""
    jc, tc = _proj_cfgs(mode)
    jlm = JQwen2(jcfg.tiny_qwen2_config())
    lm_tree = qwen2_tree(1)
    proj_tree = jax.tree.map(jnp.asarray, random_tree(
        jproj.Proj(jc).init, jnp.zeros((1, 3, 8, 64)), seed=2))
    rng = np.random.default_rng(3)
    s = 24
    ids = rng.integers(0, 512, (2, s))
    mask = np.arange(s)[None] < np.array([[s], [15]])

    weights, mix_fn = jproj.streaming_mix_spec(jc, proj_tree, 2)
    want_mixed, want_normed = jlm.apply(
        lm_tree, jnp.asarray(ids), weights, mix_fn, jnp.asarray(mask),
        method=jlm.encode_premixed)
    want = jproj.Proj(jc).apply(proj_tree, want_mixed,
                                method=jproj.Proj.mlp)

    lm = load_flax(Qwen2LM(tcfg.tiny_qwen2_config()), lm_tree)
    proj = load_flax(Proj(tc), proj_tree)
    tw, tmix = streaming_mix_spec(proj, 2)
    assert float(tw["layers"][-1].abs().sum()) == 0.0
    assert (tw["bias"] is None) == (mode != "cnn")
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    with torch.inference_mode():
        mixed, normed = lm.encode_premixed(tids, tw, tmix,
                                           attention_mask=tmask)
        got = proj.mlp(mixed)
        states, last = lm(tids, attention_mask=tmask)
        stack = proj(states)
        stack_mixed = proj.mix(states)
    assert mixed.dtype == torch.float32 and mixed.shape == (2, s, 64)
    np.testing.assert_allclose(n(mixed), n(want_mixed), **TOL)
    np.testing.assert_allclose(n(normed), n(want_normed), **TOL)
    np.testing.assert_array_equal(n(normed), n(last))
    np.testing.assert_allclose(n(mixed), n(stack_mixed), **TOL)
    for g, w, st in zip(got, want, stack):
        np.testing.assert_allclose(n(g), n(w), **TOL)
        np.testing.assert_allclose(n(g), n(st), **TOL)


def test_streaming_mix_spec_refuses_what_is_not_linear_per_channel():
    _, tc = _proj_cfgs("scale")
    proj = Proj(tc)
    with pytest.raises(ValueError, match="num_layers"):
        streaming_mix_spec(proj, 5)
    refiner = types.SimpleNamespace(cfg=dataclasses.replace(tc, use_t5=True))
    with pytest.raises(ValueError, match="t5"):
        streaming_mix_spec(refiner, 2)
    # the refiner is ported; the streamed mix still refuses it
    with pytest.raises(ValueError, match="t5"):
        streaming_mix_spec(Proj(refiner.cfg), 2)


# ------------------------------- the tiny pipeline above both thresholds

SEQ, H_PX, W_PX, STEPS = 112, 576, 64, 2
FLUX_KW = dict(attention_head_dim=64, axes_dims_rope=(16, 24, 24),
               fused_glue=True)


def _jvae_cfg():
    return jcfg.VAEConfig(block_out_channels=(32, 32, 32, 32),
                          layers_per_block=1, latent_channels=16,
                          norm_num_groups=4, dtype=jnp.float32,
                          param_dtype=jnp.float32)


def test_tiled_long_sequence_pipeline_matches_jax(monkeypatch):
    """A 576 x 64 image with a 112-token prompt: 144 + 112 = 256 joint
    tokens against MAX_KV_SEQ lowered to 128 in both packages (JAX runs its
    chunked Pallas kernel in interpret mode, the qk norm with per-row
    scales and the rope outside it), and a 72 x 8 latent against
    vae_tile_px = 256 (two tiles of 64 and 24 rows). The same noise array
    goes through JAX's ``_generate_jit`` + ``_decode_tiled_jit`` and the
    port's ``_generate``."""
    monkeypatch.setattr(jfa, "MAX_KV_SEQ", 128)
    monkeypatch.setattr(tfa, "MAX_KV_SEQ", 128)
    monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    traced = []
    chunked = jfa._flash_forward_chunked
    monkeypatch.setattr(jfa, "_flash_forward_chunked", lambda *a, **kw: (
        traced.append(a[0].shape), chunked(*a, **kw))[1])
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (1, SEQ))
    mask = np.arange(SEQ)[None] < 90
    s_img = (H_PX // 16) * (W_PX // 16)
    noise = rng.standard_normal((1, s_img, 64)).astype(np.float32)

    jlm = JQwen2(jcfg.tiny_qwen2_config())
    jflux = JFlux(jcfg.tiny_flux_config(use_pallas_attention=True, **FLUX_KW))
    jvae = JVAE(_jvae_cfg())
    jp_cfg, tp_cfg = _proj_cfgs("cnn", output_dim0=32, output_dim1=64)
    lm_t = random_tree(jlm.init, jnp.zeros((1, SEQ), jnp.int32), seed=1)
    proj_t = random_tree(jproj.Proj(jp_cfg).init,
                         jnp.zeros((1, 3, SEQ, 64)), seed=2)
    flux_t = random_tree(
        jflux.init, jnp.zeros((1, s_img, 64)), jnp.zeros((1, SEQ, 64)),
        jnp.zeros((1, 32)), jnp.zeros((1,)),
        prepare_latent_image_ids(H_PX // 8, W_PX // 8),
        jnp.zeros((SEQ, 3)), seed=3)
    vae_t = random_tree(functools.partial(jvae.init, method=jvae.decode),
                        jnp.zeros((1, 4, 4, 16)), seed=4)

    gen = dict(height=H_PX, width=W_PX, num_inference_steps=STEPS,
               vae_tile_px=256)
    jp = jpipe.X2IPipeline(
        encoder_fn=None, proj=jproj.Proj(jp_cfg), proj_params=proj_t,
        flux=jflux, flux_params=flux_t, vae=jvae, vae_params=vae_t,
        scheduler=JSched(jcfg.SchedulerConfig(shift=1.0)),
        gen_cfg=jcfg.GenerationConfig(**gen))
    states, _ = jlm.apply(lm_t, jnp.asarray(ids), jnp.asarray(mask))
    pooled, embeds = jp.proj.apply(proj_t, states)
    with pltpu.force_tpu_interpret_mode():
        lat = jp._generate_jit(flux_t, vae_t, embeds, pooled,
                               jnp.asarray(noise), None, H_PX, W_PX, STEPS)
    assert lat.shape == (1, H_PX // 8, W_PX // 8, 16)
    assert traced and set(traced) == {(1, 4, 256, 64)}
    want_img = np.asarray(jp._decode_tiled_jit(vae_t, lat))
    want = np.asarray(jax.jit(functools.partial(
        jvae.apply, method=jvae.decode_tiled))(vae_t, lat))

    dev = resolve_device("cpu")
    lm = load_flax(Qwen2LM(tcfg.tiny_qwen2_config(), dev), lm_t)
    vae = AutoencoderKL(tiny_vae_config(dtype=torch.float32), dev)
    load_flax(vae.decoder, vae_t["params"]["decoder"])
    encoder_fn, _ = lm_text_encoder(lm, lambda text: (ids[0], mask[0]))
    pipe = X2IPipeline(
        encoder_fn=encoder_fn, proj=load_flax(Proj(tp_cfg, dev), proj_t),
        flux=load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
            attention_impl="kernel", **FLUX_KW), dev), flux_t),
        vae=vae,
        scheduler=FlowMatchEulerScheduler(tcfg.SchedulerConfig(shift=1.0)),
        gen_cfg=tcfg.GenerationConfig(**gen))
    tiled = []
    decode_tiled = vae.decode_tiled
    vae.decode_tiled = lambda z: (tiled.append(tuple(z.shape)),
                                  decode_tiled(z))[1]
    p_pooled, p_embeds = pipe.encode({"prompt": "a cat"})
    got = pipe._generate(torch.from_numpy(noise), p_embeds, p_pooled, H_PX,
                         W_PX, STEPS).numpy()
    assert tiled == [(1, H_PX // 8, W_PX // 8, 16)]
    assert got.shape == want.shape == (1, H_PX, W_PX, 3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    img = postprocess(torch.from_numpy(got)).numpy().astype(int)
    assert np.abs(img - want_img.astype(int)).max() <= 1
