"""LightControl (X2I's phase 2) in the port against the JAX package on the
CPU, in float32 at tiny sizes, on the same weights (through the bridge)
and the same numpy inputs and random draws:

* one ControlNeXt branch (at the harness's tiny widths and at the
  reference widths on a 64^2 image), a bank of three under both ``impl``s;
* the tiny FLUX with ``controls=`` on the plain, "ln" and "quant" glue
  routes (JAX's Pallas glue in interpret mode), with precomputed mods, and
  its gradient with respect to the controls under remat;
* the VAE's encode (the mode, and a sample on JAX's noise) and
  ``preprocess``; the training samplers;
* the tiny pipeline with ``with_controls`` and ``control_pixels``;
* the bank's checkpoint plan on a reference-layout state dict.

Tolerance 1e-4 (absolute and relative) unless a test states another:
float32 sums in another order through convolutions, a few DiT blocks and
an optimizer step.

The phase-2 training step is in test_torch_lightcontrol_train.py, with
these helpers and bars, so that the test runner's workers take both
files at once."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from safetensors.torch import save_file

from test_torch_params import flux_tree, one_thread, random_tree
from x2i_tpu.convert.load import controlnext_bank_params_from_reference
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion import scheduler as jsched
from x2i_tpu.models import controlnext as jcn
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.models.vae import AutoencoderKL as JVAE
from x2i_tpu.models.vae import preprocess as jpreprocess
from x2i_tpu.ops import quant as jq
from x2i_tpu.pipeline import X2IPipeline as JPipeline
from x2i_torch.convert import load as tload
from x2i_torch.convert import torch_models as ttm
from x2i_torch.core import config as tcfg
from x2i_torch.diffusion import scheduler as tsched
from x2i_torch.diffusion.sampling import prepare_latent_image_ids
from x2i_torch.models.controlnext import (ControlBank, ControlNeXt,
                                          apply_control_bank)
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.vae import AutoencoderKL, postprocess, preprocess
from x2i_torch.params import load_flax, load_flax_bank, random_init_
from x2i_torch.pipeline import X2IPipeline, build_random_pipeline

TOL = dict(atol=1e-4, rtol=1e-4)


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def ctrl_cfgs(final=128, reference=False):
    """(JAX, port) ControlNeXt configs in f32: the harness's tiny widths,
    or the reference's (128 / 256 channels, 3072 out)."""
    kw = {} if reference else dict(in_channels=(8, 8), out_channels=(8, 16),
                                   groups=(2, 2), time_embed_dim=16,
                                   final_out_channels=final)
    return (jcfg.ControlNeXtConfig(dtype=jnp.float32,
                                   param_dtype=jnp.float32, **kw),
            tcfg.ControlNeXtConfig(dtype=torch.float32, **kw))


def branch_tree(jc, px, seed):
    return random_tree(jcn.ControlNeXt(jc).init, jnp.zeros((1, px, px, 3)),
                       jnp.zeros((1,)), seed=seed)


def bank_tree(jc, px, count, seed=0):
    """JAX's stacked bank: ``count`` branch trees on a leading axis."""
    trees = [branch_tree(jc, px, seed + i) for i in range(count)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


# ---------------------------------------------------------------- branches

@pytest.mark.parametrize("reference", [False, True])
def test_branch_matches_jax(reference):
    """One branch at the tiny widths (32^2, 4 tokens) and at the reference
    widths (64^2, 16 tokens of 3072), two samples at two timesteps."""
    jc, tc = ctrl_cfgs(reference=reference)
    px = 64 if reference else 32
    tree = branch_tree(jc, px, seed=1)
    rng = np.random.default_rng(1)
    pixels = rng.uniform(-1, 1, (2, px, px, 3)).astype(np.float32)
    steps = np.array([250.0, 980.0], np.float32)
    want = jax.jit(jcn.ControlNeXt(jc).apply)(tree, pixels, steps)["out"]
    model = load_flax(ControlNeXt(tc), tree)
    with torch.no_grad():
        got = model(t(pixels), t(steps))
    tokens = (px // 16) ** 2
    assert got.shape == (2, tokens, tc.final_out_channels) == want.shape
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_bank_matches_jax_under_both_impls():
    """A bank of three against apply_control_bank under "vmap" and
    "scan": the branches differ (their own weights), "scan" gives
    "vmap"'s values and gradients in the port."""
    jc, tc = ctrl_cfgs()
    tree = bank_tree(jc, 32, 3)
    rng = np.random.default_rng(2)
    pixels = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    steps = np.array([100.0], np.float32)
    bank = load_flax_bank(ControlBank(tc, 3), tree)
    outs = {}
    for impl in ("vmap", "scan"):
        want = jax.jit(functools.partial(jcn.apply_control_bank, jc,
                                         impl=impl))(tree, pixels, steps)
        with torch.no_grad():
            outs[impl] = got = apply_control_bank(bank, t(pixels), t(steps),
                                                  impl)
        assert got.shape == (3, 1, 4, 128)
        np.testing.assert_allclose(n(got), n(want), **TOL)
    assert torch.equal(outs["vmap"], outs["scan"])
    assert not np.allclose(n(outs["vmap"][0]), n(outs["vmap"][1]))

    grads = {}
    for impl in ("vmap", "scan"):
        bank.zero_grad()
        apply_control_bank(bank, t(pixels), t(steps), impl).square().sum(
            ).backward()
        grads[impl] = [p.grad.clone() for p in bank.parameters()]
    for a, b in zip(grads["vmap"], grads["scan"]):
        np.testing.assert_allclose(n(a), n(b), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        apply_control_bank(bank, t(pixels), t(steps), "pmap")


# ------------------------------------------------------------ FLUX + controls

def _flux_args(cfg, s_img=16, s_txt=8, seed=3):
    rng = np.random.default_rng(seed)
    grid = int(2 * s_img ** 0.5)
    return [rng.standard_normal((1, s_img, cfg.in_channels)),
            rng.standard_normal((1, s_txt, cfg.joint_attention_dim)),
            rng.standard_normal((1, cfg.pooled_projection_dim)),
            np.array([0.6]), np.asarray(prepare_latent_image_ids(grid, grid)),
            np.zeros((s_txt, 3))], rng


@pytest.mark.parametrize("route", ["plain", "ln", "quant"])
def test_flux_with_controls_matches_jax(route):
    """The tiny FLUX with controls on each glue route against JAX's (the
    Pallas glue in interpret mode): "plain" and "ln" in f32 at 1e-4, the
    w8a8 "quant" route at relative L2 1e-3 (tests/test_torch_quant.py's
    bar for it); zero controls give the model without them exactly, as do
    precomputed mods the inline ones."""
    kw = {"plain": {}, "ln": dict(fused_glue=True),
          "quant": dict(fused_glue=True, quantized="w8a8")}[route]
    jc, tc = jcfg.tiny_flux_config(**kw), tcfg.tiny_flux_config(**kw)
    tree = flux_tree(3)
    if route == "quant":
        tree = jq.quantize_tree(tree, "w8a8")
    args, rng = _flux_args(jc)
    controls = 0.5 * rng.standard_normal((jc.num_layers, 1, 16,
                                          jc.inner_dim))
    with pltpu.force_tpu_interpret_mode():
        want = n(jax.jit(JFlux(jc).apply)(
            tree, *(jnp.asarray(a, jnp.float32) for a in args),
            controls=jnp.asarray(controls, jnp.float32)))
    model = load_flax(FluxTransformer2D(tc), tree)
    targs = [t(a) for a in args]
    with torch.no_grad():
        got = n(model(*targs, controls=t(controls)))
        plain = model(*targs)
        zero = model(*targs, controls=torch.zeros(controls.shape))
        mods = model(targs[0], targs[1], targs[2], t([0.6, 0.3]),
                     *targs[4:], mods_only=True)
        step0 = model(*targs, controls=t(controls),
                      precomputed_mods={k: v[0] for k, v in mods.items()})
    assert torch.equal(zero, plain)
    assert not np.allclose(got, n(plain), atol=1e-3)
    np.testing.assert_allclose(n(step0), got, atol=1e-6, rtol=1e-6)
    if route == "quant":
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_flux_control_gradient_matches_jax_under_remat():
    """d(sum of squares of the velocity)/d(controls) against jax.grad, and
    the same with the per-block checkpoint (remat) on."""
    jc = jcfg.tiny_flux_config()
    tree = flux_tree(4)
    args, rng = _flux_args(jc, seed=4)
    controls = 0.5 * rng.standard_normal((jc.num_layers, 1, 16,
                                          jc.inner_dim))
    jargs = [jnp.asarray(a, jnp.float32) for a in args]
    want = jax.jit(jax.grad(lambda c: jnp.sum(JFlux(jc).apply(
        tree, *jargs, controls=c) ** 2)))(jnp.asarray(controls, jnp.float32))
    for remat in (False, True):
        model = load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
            remat=remat)), tree).requires_grad_(False)
        c = t(controls).requires_grad_()
        model(*(t(a) for a in args), controls=c).square().sum().backward()
        np.testing.assert_allclose(n(c.grad), n(want), **TOL)


# --------------------------------------------------------------- the VAE

def _vae_cfgs():
    kw = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
              latent_channels=4, norm_num_groups=4)
    return (jcfg.VAEConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            tcfg.VAEConfig(dtype=torch.float32, **kw))


def test_vae_encode_and_preprocess_match_jax():
    """The mode, a sample on JAX's own noise (the key's draw of the
    moments' shape) and the moments, on 40 x 24 pixels (odd latent sides
    after the asymmetric downsample pads); preprocess bit for bit."""
    jc, tc = _vae_cfgs()
    vae = JVAE(jc)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (2, 40, 24, 3)).astype(np.uint8)
    pixels = np.asarray(jpreprocess(jnp.asarray(images)))
    np.testing.assert_array_equal(
        preprocess(torch.as_tensor(images)).numpy(), pixels)
    tree = random_tree(vae.init, jnp.zeros((1, 40, 24, 3)), seed=5)
    model = load_flax(AutoencoderKL(tc), tree)
    key = jax.random.key(7)
    enc = functools.partial(vae.apply, method=vae.encode)
    mode = jax.jit(enc)(tree, pixels)
    sample = jax.jit(enc)(tree, pixels, key)
    moments = jax.jit(functools.partial(vae.apply, method=vae.encode_moments)
                      )(tree, pixels)
    eps = jax.random.normal(key, mode.shape, jnp.float32)
    with torch.no_grad():
        got_mode = model.encode(t(pixels))
        got_sample = model.encode(t(pixels), eps=t(eps))
        got_moments = model.encode_moments(t(pixels))
    assert got_mode.shape == (2, 5, 3, 4) == mode.shape
    np.testing.assert_allclose(n(got_moments), n(moments), **TOL)
    np.testing.assert_allclose(n(got_mode), n(mode), **TOL)
    np.testing.assert_allclose(n(got_sample), n(sample), **TOL)
    assert not np.allclose(n(got_sample), n(got_mode), atol=1e-3)


# --------------------------------------------------------------- samplers

def test_training_samplers_match_jax():
    """add_noise, the timestep density on JAX's normals / uniforms, and
    the loss weightings."""
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((3, 4, 2, 2)).astype(np.float32)
    z = rng.standard_normal((3, 4, 2, 2)).astype(np.float32)
    sig = np.array([0.1, 0.5, 0.97], np.float32)
    np.testing.assert_allclose(
        n(tsched.FlowMatchEulerScheduler.add_noise(t(x0), t(z), t(sig))),
        n(jsched.FlowMatchEulerScheduler.add_noise(x0, z, sig)), atol=1e-7)
    key = jax.random.key(3)
    for scheme, draw in (("logit_normal", jax.random.normal),
                         ("mode", jax.random.uniform),
                         ("uniform", jax.random.uniform)):
        want = jsched.compute_density_for_timestep_sampling(
            key, 5, scheme, 0.2, 1.3)
        got = tsched.compute_density_for_timestep_sampling(
            5, scheme, 0.2, 1.3, draws=t(draw(key, (5,))))
        np.testing.assert_allclose(n(got), n(want), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    u = tsched.compute_density_for_timestep_sampling(5, generator=g)
    assert u.shape == (5,) and bool(((u > 0) & (u < 1)).all())
    for scheme in ("sigma_sqrt", "cosmap", "none"):
        np.testing.assert_allclose(
            n(tsched.loss_weighting(scheme, t(sig))),
            n(jsched.loss_weighting(scheme, sig)), rtol=1e-6)


# ------------------------------------------------------------ the pipeline

def test_pipeline_with_controls_matches_jax():
    """The tiny FLUX + VAE with a bank of two branches: JAX's
    ``_generate_jit`` with control pixels and the port's ``_generate`` on
    the same noise and conditioning, images within one level; without
    the pixels the image is another."""
    px, steps = 64, 2
    jfc, tfc = jcfg.tiny_flux_config(), tcfg.tiny_flux_config()
    jc, tc = ctrl_cfgs(final=jfc.inner_dim)
    vkw = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1,
               latent_channels=16, norm_num_groups=4)
    jvae = JVAE(jcfg.VAEConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                               **vkw))
    flux_t = flux_tree(8)
    vae_t = random_tree(functools.partial(jvae.init, method=jvae.decode),
                        jnp.zeros((1, 4, 4, 16)), seed=8)
    bank_t = bank_tree(jc, px, jfc.num_layers, seed=8)
    rng = np.random.default_rng(8)
    noise = rng.standard_normal((1, (px // 16) ** 2, 64)).astype(np.float32)
    embeds = rng.standard_normal((1, 8, 64)).astype(np.float32)
    pooled = rng.standard_normal((1, 32)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (1, px, px, 3)).astype(np.float32)
    gen = dict(height=px, width=px, num_inference_steps=steps)
    jp = JPipeline(encoder_fn=None, proj=None, proj_params=None,
                   flux=JFlux(jfc), flux_params=flux_t, vae=jvae,
                   vae_params=vae_t,
                   scheduler=jsched.FlowMatchEulerScheduler(
                       jcfg.SchedulerConfig(shift=1.0)),
                   gen_cfg=jcfg.GenerationConfig(**gen)).with_controls(
        jc, jax.tree_util.tree_map(jnp.asarray, bank_t))
    want = np.asarray(jp._generate_jit(flux_t, vae_t, embeds, pooled, noise,
                                       jnp.asarray(ctrl), px, px, steps))

    vae = AutoencoderKL(tcfg.VAEConfig(dtype=torch.float32, **vkw))
    load_flax(vae.decoder, vae_t["params"]["decoder"])
    pipe = X2IPipeline(
        encoder_fn=None, proj=None, flux=load_flax(FluxTransformer2D(tfc),
                                                   flux_t),
        vae=vae, scheduler=tsched.FlowMatchEulerScheduler(
            tcfg.SchedulerConfig(shift=1.0)),
        gen_cfg=tcfg.GenerationConfig(**gen))
    cpipe = pipe.with_controls(tc, load_flax_bank(
        ControlBank(tc, tfc.num_layers), bank_t))
    assert pipe.control_bank is None and cpipe.control_cfg is tc
    got = postprocess(cpipe._generate(t(noise), t(embeds), t(pooled), px, px,
                                      steps, t(ctrl))).numpy().astype(int)
    assert got.shape == want.shape == (1, px, px, 3)
    assert np.abs(got - want.astype(int)).max() <= 1
    plain = postprocess(cpipe._generate(t(noise), t(embeds), t(pooled), px,
                                        px, steps)).numpy().astype(int)
    assert np.abs(plain - got).max() > 1


def test_run_task_passes_control_pixels():
    """The public entry points: ``control_pixels`` reaches the denoise
    through run_task's gen_kwargs; a bank with zeroed output convs gives
    the image without controls bit for bit, a drawn one another image;
    pixels without a bank raise."""
    pipe = build_random_pipeline(device="cpu", dtype=torch.float32)
    _, tc = ctrl_cfgs(final=pipe.flux.cfg.inner_dim)
    bank = random_init_(ControlBank(tc, pipe.flux.cfg.num_layers),
                        torch.Generator().manual_seed(0))
    cpipe = pipe.with_controls(tc, bank)
    ctrl = torch.rand((1, 64, 64, 3), generator=torch.Generator(
        ).manual_seed(1)) * 2 - 1
    plain = pipe.text2image("a cat")
    img = cpipe.text2image("a cat", control_pixels=ctrl)
    assert img.shape == (1, 64, 64, 3) and not np.array_equal(img, plain)
    with torch.no_grad():
        for br in bank.branches:
            br.out_conv.weight.zero_()
            br.out_conv.bias.zero_()
    np.testing.assert_array_equal(
        cpipe.run_task("text2image", prompt="a cat", control_pixels=ctrl),
        plain)
    with pytest.raises(ValueError, match="with_controls"):
        pipe.text2image("a cat", control_pixels=ctrl)


# ------------------------------------------------------------- checkpoints

def _reference_bank_sd(tc, count, seed=9):
    """A reference-layout bank state dict (``{i}.time_embedding.linear_1.
    weight`` ...) drawn from numpy, as the reference's trainer saves it:
    the plan's keys with the shapes of the port's parameters."""
    rng = np.random.default_rng(seed)
    shapes = dict(ControlBank(tc, count).named_parameters())
    plan = ttm.controlnext_plan(tc, count)
    return {k: torch.as_tensor(rng.standard_normal(
        tuple(shapes[dst[0]].shape)).astype(np.float32))
        for k, dst in plan.items()}


@pytest.mark.parametrize("form", ["file", "dir", "bin"])
def test_bank_checkpoint_matches_jax_converter(tmp_path, form):
    """``load_control_bank`` on the reference's bank, written as one
    safetensors file, a directory of two shards, or a torch .bin, equals
    ``controlnext_bank_params_from_reference`` + the bridge bit for bit;
    a key the plan does not read raises."""
    _, tc = ctrl_cfgs()
    sd = _reference_bank_sd(tc, 3)
    if form == "file":
        path = str(tmp_path / "bank.safetensors")
        save_file(sd, path)
    elif form == "dir":
        path = str(tmp_path)
        keys = sorted(sd)
        for i, part in enumerate((keys[::2], keys[1::2])):
            save_file({k: sd[k] for k in part},
                      str(tmp_path / f"bank-{i}.safetensors"))
    else:
        path = str(tmp_path / "bank.bin")
        torch.save(sd, path)
    bank = tload.load_control_bank(path, tc, device="cpu", num_controls=3)
    assert bank.load_report["tensors"] == len(sd)
    want = load_flax_bank(ControlBank(tc, 3),
                          controlnext_bank_params_from_reference(
                              {k: v.numpy() for k, v in sd.items()}, 3))
    for (k, a), b in zip(bank.state_dict().items(),
                         want.state_dict().values()):
        assert torch.equal(a, b), k
    bad = dict(sd, **{"0.scale": torch.ones(1)})
    save_file(bad, str(tmp_path / "bad.safetensors"))
    with pytest.raises(KeyError, match="0.scale"):
        tload.load_control_bank(str(tmp_path / "bad.safetensors"), tc,
                                device="cpu", num_controls=3)
