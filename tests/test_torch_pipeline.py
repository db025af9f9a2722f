"""The whole text->image slice of the port against the JAX package on the
CPU: tiny float32 weights carried across by the bridge, the same token ids
and the same noise. Pre-postprocess pixels agree to 1e-4 of their largest
magnitude, uint8 images to one level."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_params import one_thread, random_tree
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion.sampling import (denoise_flux, prepare_latent_image_ids,
                                        unpack_latents)
from x2i_tpu.diffusion.scheduler import FlowMatchEulerScheduler as JSched
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.models.proj import Proj as JProj
from x2i_tpu.models.qwen2 import Qwen2LM as JQwen2
from x2i_tpu.models.vae import AutoencoderKL as JVAE
from x2i_torch.core import config as tcfg
from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.vae import AutoencoderKL, postprocess
from x2i_torch.params import load_flax
from x2i_torch.pipeline import (X2IPipeline, build_random_pipeline,
                                lm_text_encoder, resolve_device,
                                tiny_vae_config)

SEQ, PX, STEPS = 32, 64, 4


def _jax_slice(ids, mask, noise, trees):
    """The JAX package's text path: LM prefill -> proj -> precomputed-mods
    denoise -> unpack -> VAE decode, on the given trees."""
    lm_t, proj_t, flux_t, vae_t = trees
    lm, proj = JQwen2(jcfg.tiny_qwen2_config()), JProj(_jproj_cfg())
    flux = JFlux(jcfg.tiny_flux_config())
    vae = JVAE(_jvae_cfg())
    states, _ = lm.apply(lm_t, ids, mask)
    pooled, embeds = proj.apply(proj_t, states)
    sigmas = JSched(jcfg.SchedulerConfig(shift=1.0)).inference_sigmas(STEPS)
    lat = denoise_flux(flux, flux_t, noise, embeds, pooled,
                       sigmas, prepare_latent_image_ids(PX // 8, PX // 8),
                       jnp.zeros((SEQ, 3), jnp.float32))
    lat = jnp.transpose(unpack_latents(lat, PX, PX), (0, 2, 3, 1))
    return vae.apply(vae_t, lat, method=vae.decode)


def _jproj_cfg():
    return jcfg.ProjConfig(in_channels=3, input_dim=64, output_dim0=32,
                           output_dim1=64, dtype=jnp.float32,
                           param_dtype=jnp.float32)


def _jvae_cfg():
    return jcfg.VAEConfig(block_out_channels=(32, 32, 32, 32),
                          layers_per_block=1, latent_channels=16,
                          norm_num_groups=4, dtype=jnp.float32,
                          param_dtype=jnp.float32)


def _trees():
    lm = JQwen2(jcfg.tiny_qwen2_config())
    flux = JFlux(jcfg.tiny_flux_config())
    vae = JVAE(_jvae_cfg())
    s_img = (PX // 16) ** 2
    return (random_tree(lm.init, jnp.zeros((1, SEQ), jnp.int32), seed=1),
            random_tree(JProj(_jproj_cfg()).init,
                        jnp.zeros((1, 3, SEQ, 64)), seed=2),
            random_tree(flux.init, jnp.zeros((1, s_img, 64)),
                        jnp.zeros((1, SEQ, 64)), jnp.zeros((1, 32)),
                        jnp.zeros((1,)),
                        prepare_latent_image_ids(PX // 8, PX // 8),
                        jnp.zeros((SEQ, 3)), seed=3),
            random_tree(functools.partial(vae.init, method=vae.decode),
                        jnp.zeros((1, 4, 4, 16)), seed=4))


def _port_pipeline(trees, tokenize):
    lm_t, proj_t, flux_t, vae_t = trees
    dev = resolve_device("cpu")
    lm = load_flax(Qwen2LM(tcfg.tiny_qwen2_config(), dev), lm_t)
    vae = AutoencoderKL(tiny_vae_config(dtype=torch.float32), dev)
    load_flax(vae.decoder, vae_t["params"]["decoder"])
    proj_cfg = tcfg.ProjConfig(in_channels=3, input_dim=64, output_dim0=32,
                               output_dim1=64, dtype=torch.float32)
    encoder_fn, encoder_batch_fn = lm_text_encoder(lm, tokenize)
    return X2IPipeline(
        encoder_fn=encoder_fn,
        proj=load_flax(Proj(proj_cfg, dev), proj_t),
        flux=load_flax(FluxTransformer2D(tcfg.tiny_flux_config(), dev),
                       flux_t),
        vae=vae,
        scheduler=FlowMatchEulerScheduler(tcfg.SchedulerConfig(shift=1.0)),
        gen_cfg=tcfg.GenerationConfig(height=PX, width=PX,
                                      num_inference_steps=STEPS),
        encoder_batch_fn=encoder_batch_fn)


def test_text2image_slice_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (1, SEQ))
    mask = np.arange(SEQ)[None] < 21                  # right-padded prompt
    noise = rng.standard_normal((1, (PX // 16) ** 2, 64)).astype(np.float32)
    trees = _trees()
    want = np.asarray(jax.jit(_jax_slice)(ids, mask, noise, trees))

    pipe = _port_pipeline(trees, lambda text: (ids[0], mask[0]))
    pooled, embeds = pipe.encode({"prompt": "a cat"})
    got = pipe._generate(torch.from_numpy(noise), embeds, pooled, PX, PX,
                         STEPS).numpy()
    assert got.shape == want.shape == (1, PX, PX, 3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    img_t = postprocess(torch.from_numpy(got)).numpy().astype(int)
    img_j = np.round(np.clip(want / 2 + 0.5, 0, 1) * 255).astype(int)
    assert np.abs(img_t - img_j).max() <= 1


def test_server_answers_three_requests():
    pipe = build_random_pipeline(device="cpu", dtype=torch.float32)
    server = pipe.serving_server(batch_size=2, max_wait_s=0.5,
                                 buckets=[1, 2])
    sizes = []
    run = server.generate_batch
    server.generate_batch = lambda reqs: (sizes.append(len(reqs)),
                                          run(reqs))[1]
    try:
        futs = [server.submit({"prompt": p}) for p in ("a", "b", "c")]
        images = [f.result(timeout=120) for f in futs]
    finally:
        server.close()
    assert not server._thread.is_alive()
    assert [i.shape for i in images] == [(PX, PX, 3)] * 3
    assert all(i.dtype == np.uint8 for i in images)
    assert sizes == [2, 1]
    # the lone third request ran as a batch of one: its image is the one
    # its prompt gets from text2image (same seed, same noise)
    np.testing.assert_array_equal(images[2], pipe.text2image("c")[0])


def test_generate_draws_bf16_noise_for_an_f32_dit():
    """The noise is bf16 whatever the DiT's dtype, as the JAX pipeline
    draws it."""
    pipe = build_random_pipeline(device="cpu", dtype=torch.float32)
    assert pipe.flux.cfg.dtype == torch.float32
    noises = []
    generate = pipe._generate
    pipe._generate = lambda noise, *a: (noises.append(noise),
                                        generate(noise, *a))[1]
    img = pipe.text2image("a")
    assert img.shape == (1, PX, PX, 3)
    assert [(n.dtype, tuple(n.shape)) for n in noises] == [
        (torch.bfloat16, (1, (PX // 16) ** 2, 64))]


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_random_pipeline()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_pipeline_refuses_what_is_not_ported():
    pipe = build_random_pipeline(device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        pipe.encode({"prompt": "x", "images": ["img.png"]})
    # above vae_tile_px the tiled decode runs (it used to be refused)
    pipe.gen_cfg = dataclasses.replace(pipe.gen_cfg, vae_tile_px=64)
    tiled = []
    decode_tiled = pipe.vae.decode_tiled
    pipe.vae.decode_tiled = lambda z: (tiled.append(tuple(z.shape)),
                                       decode_tiled(z, tile_latent=8))[1]
    img = pipe.generate(*pipe.encode({"prompt": "x"}), height=96, width=64)
    assert img.shape == (1, 96, 64, 3) and img.dtype == np.uint8
    assert tiled == [(1, 12, 8, 16)]
    pipe.generate(*pipe.encode({"prompt": "x"}), height=64, width=64)
    assert len(tiled) == 1
