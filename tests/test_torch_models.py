"""The port's models and diffusion pieces against the JAX package's on the
CPU, in float32 at tiny sizes, on the same weights (carried across by the
bridge) and the same numpy inputs. Tolerance: 1e-4 absolute on outputs of
order 1 (float32 summation order through a few blocks)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import (flux_tree, one_thread, proj_cfgs, qwen2_tree,
                               random_tree, vae_cfgs)
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion import sampling as jsamp
from x2i_tpu.diffusion.scheduler import FlowMatchEulerScheduler as JSched
from x2i_tpu.models import flux as jflux
from x2i_tpu.models.proj import Proj as JProj
from x2i_tpu.models.qwen2 import Qwen2LM as JQwen2
from x2i_tpu.models.vae import AutoencoderKL as JVAE
from x2i_tpu.models.vae import postprocess as jpostprocess
from x2i_torch.core import config as tcfg
from x2i_torch.diffusion import sampling as tsamp
from x2i_torch.diffusion.scheduler import FlowMatchEulerScheduler as TSched
from x2i_torch.models import flux as tflux
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.vae import AutoencoderKL, postprocess
from x2i_torch.params import load_flax

jattn = importlib.import_module("x2i_tpu.ops.attention")
TOL = dict(atol=1e-4, rtol=1e-4)
# float32 products and convolutions in full float32 on a card too (TF32
# off, as the port's entry points set it; the CPU ignores both flags)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flux_inputs(rng, cfg, s_img, s_txt):
    grid = int(2 * s_img ** 0.5)
    return dict(
        lat=rng.standard_normal((1, s_img, cfg.in_channels)),
        txt=rng.standard_normal((1, s_txt, cfg.joint_attention_dim)),
        pooled=rng.standard_normal((1, cfg.pooled_projection_dim)),
        t=np.array([0.7], np.float32),
        img_ids=np.asarray(jsamp.prepare_latent_image_ids(grid, grid)),
        txt_ids=np.zeros((s_txt, 3), np.float32))


def _run_flux(jc, tc, s_img, s_txt, seed=0, kernel_route=False,
              monkeypatch=None):
    rng = np.random.default_rng(seed)
    x = _flux_inputs(rng, jc, s_img, s_txt)
    tree = flux_tree(seed, jc, s_img, s_txt)
    args = [x[k] for k in ("lat", "txt", "pooled", "t", "img_ids",
                           "txt_ids")]
    if kernel_route:
        monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jflux.FluxTransformer2D(jc).apply)(
            tree, *(jnp.asarray(a) for a in args))
    model = load_flax(tflux.FluxTransformer2D(tc), tree)
    with torch.inference_mode():
        got = model(*(t(a) for a in args))
    return n(got), n(want), model, [t(a) for a in args]


@pytest.mark.parametrize("fused", [False, True])
def test_flux_forward_matches_jax(fused):
    """Both glue modes: LayerNorm + modulate and the qk norm unfused, or
    through ln_mod and the attention call (plain versions on the CPU)."""
    got, want, _, _ = _run_flux(jcfg.tiny_flux_config(fused_glue=fused),
                                tcfg.tiny_flux_config(fused_glue=fused),
                                16, 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_flux_kernel_route_matches_jax_interpret(monkeypatch):
    """head_dim 64 at 128 joint tokens: the JAX side takes its real kernel
    route (flash attention with in-kernel rope and per-row qk norm, and
    the ln_mod kernel) in interpret mode, the port its kernel wrappers."""
    kw = dict(attention_head_dim=64, axes_dims_rope=(16, 24, 24),
              fused_glue=True)
    got, want, _, _ = _run_flux(
        jcfg.tiny_flux_config(use_pallas_attention=True, **kw),
        tcfg.tiny_flux_config(attention_impl="kernel", **kw), 64, 64,
        kernel_route=True, monkeypatch=monkeypatch)
    np.testing.assert_allclose(got, want, **TOL)


def test_precomputed_mods_equal_inline_mods():
    jc, tc = jcfg.tiny_flux_config(), tcfg.tiny_flux_config()
    _, want, model, args = _run_flux(jc, tc, 16, 8, seed=3)
    sigmas = torch.tensor([1.0, 0.7, 0.2])
    tree = flux_tree(3, jc, 16, 8)
    jmods = jflux.FluxTransformer2D(jc).apply(
        tree, *(jnp.asarray(n(a)) for a in args[:3]), jnp.asarray(n(sigmas)),
        *(jnp.asarray(n(a)) for a in args[4:]), mods_only=True)
    with torch.inference_mode():
        mods = model(*args[:3], sigmas, *args[4:], mods_only=True)
        step = {k: v[1] for k, v in mods.items()}
        got = model(*args, precomputed_mods=step)
        inline = model(*args)
    for key in ("double_img", "double_txt", "single"):
        np.testing.assert_allclose(n(mods[key]), n(jmods[key]), **TOL)
    # the mods pass runs each dense over all T steps' rows at once, which
    # changes the float32 summation order only
    np.testing.assert_allclose(n(got), n(inline), atol=1e-5)
    np.testing.assert_allclose(n(got), want, **TOL)


def _qwen2_case(jc, tc, s, lengths, seed=0):
    rng = np.random.default_rng(seed)
    tree = qwen2_tree(seed, jc)
    ids = rng.integers(0, jc.vocab_size, (len(lengths), s))
    mask = np.arange(s)[None] < np.array(lengths)[:, None]
    want_all, want_last = jax.jit(JQwen2(jc).apply)(
        tree, jnp.asarray(ids), jnp.asarray(mask))
    model = load_flax(Qwen2LM(tc), tree)
    with torch.inference_mode():
        got_all, got_last = model(torch.as_tensor(ids),
                                  attention_mask=torch.as_tensor(mask))
    return model, ids, (n(got_all), n(got_last)), (n(want_all),
                                                  n(want_last))


def test_qwen2_hidden_stack_matches_jax():
    """(B, L+1, S, H): embeddings first, blocks 1..L-1, then the last
    block final-normed; right-padded masks, positions cumsum(mask)-1."""
    model, ids, got, want = _qwen2_case(jcfg.tiny_qwen2_config(),
                                        tcfg.tiny_qwen2_config(), 24,
                                        [24, 15])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert got[0].shape == (2, 3, 24, 64)
    with torch.inference_mode():
        emb = model.embed(torch.as_tensor(ids))
    np.testing.assert_array_equal(got[0][:, 0], n(emb))
    np.testing.assert_array_equal(got[0][:, -1], got[1])


def test_qwen2_kernel_route_matches_jax_interpret(monkeypatch):
    """head_dim 64 at 128 tokens: the JAX prefill takes its masked causal
    GQA flash kernel in interpret mode, the port its kernel wrapper."""
    kw = dict(head_dim=64, num_attention_heads=4, num_key_value_heads=2)
    monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        _, _, got, want = _qwen2_case(
            jcfg.tiny_qwen2_config(use_pallas_attention=True, **kw),
            tcfg.tiny_qwen2_config(attention_impl="kernel", **kw), 128,
            [128, 77])
    np.testing.assert_allclose(got[0], want[0], **TOL)


@pytest.mark.parametrize("mode", ["scale", "cnn", "mean"])
def test_proj_matches_jax(mode):
    jc, tc = proj_cfgs(mode)
    tree = random_tree(JProj(jc).init, jnp.zeros((1, 3, 8, 16)))
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 16))
    want = JProj(jc).apply(tree, jnp.asarray(x, jnp.float32))
    with torch.inference_mode():
        got = load_flax(Proj(tc), tree)(t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)


def test_vae_decode_matches_jax():
    """NHWC latents in, NHWC pixels out, as in the JAX package."""
    jc, tc = vae_cfgs()
    vae = JVAE(jc)
    tree = random_tree(functools.partial(vae.init, method=vae.decode),
                       jnp.zeros((1, 4, 4, 16)))
    z = np.random.default_rng(2).standard_normal((1, 8, 8, 16))
    want = jax.jit(functools.partial(vae.apply, method=vae.decode))(
        tree, jnp.asarray(z, jnp.float32))
    model = AutoencoderKL(tc)
    load_flax(model.decoder, tree["params"]["decoder"])
    with torch.inference_mode():
        got = model.decode(t(z))
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_array_equal(postprocess(t(n(want))).numpy(),
                                  np.asarray(jpostprocess(want)))


@pytest.mark.parametrize("dynamic", [False, True])
def test_scheduler_matches_jax(dynamic):
    jc = jcfg.SchedulerConfig(shift=3.0, use_dynamic_shifting=dynamic)
    tc = tcfg.SchedulerConfig(shift=3.0, use_dynamic_shifting=dynamic)
    np.testing.assert_allclose(
        n(TSched(tc).inference_sigmas(4, image_seq_len=1024)),
        n(JSched(jc).inference_sigmas(4, image_seq_len=1024)), atol=1e-7)
    rng = np.random.default_rng(4)
    x, v = rng.standard_normal((2, 6)), rng.standard_normal((2, 6))
    np.testing.assert_allclose(
        n(TSched.step(t(x), t(v), torch.tensor(0.75), torch.tensor(0.5))),
        n(JSched.step(jnp.asarray(x, jnp.float32), jnp.asarray(v),
                      jnp.float32(0.75), jnp.float32(0.5))), atol=1e-7)


def test_pack_unpack_and_ids_match_jax():
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((2, 16, 8, 12)).astype(np.float32)
    packed = tsamp.pack_latents(t(lat))
    np.testing.assert_array_equal(n(packed),
                                  n(jsamp.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(
        n(tsamp.unpack_latents(packed, 64, 96)),
        n(jsamp.unpack_latents(jnp.asarray(n(packed)), 64, 96)))
    np.testing.assert_array_equal(n(tsamp.unpack_latents(packed, 64, 96)),
                                  lat)
    np.testing.assert_array_equal(n(tsamp.prepare_latent_image_ids(8, 12)),
                                  n(jsamp.prepare_latent_image_ids(8, 12)))
    ts = np.array([0.0, 0.25, 1.0], np.float32) * 1000
    np.testing.assert_allclose(
        n(tflux.timestep_embedding(t(ts), 32)),
        n(jflux.timestep_embedding(jnp.asarray(ts), 32)), atol=1e-5)
