"""LightControl's phase-2 training step in the port against the JAX
package on the CPU (the helpers and the tolerance of
test_torch_lightcontrol.py, which holds the serving side): the step on
``build_tiny_lightcontrol``'s weights for three steps, and with two-step
accumulation for four, on JAX's draws; the tiny harness's batch; an int
seed and the refusals; the card's harness on the tiny pipeline."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lightcontrol import TOL, bank_tree, ctrl_cfgs, n, t
from test_torch_params import one_thread, random_tree
from x2i_tpu.core import config as jcfg
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.models.vae import AutoencoderKL as JVAE
from x2i_tpu.train import harness as jharness
from x2i_tpu.train import lightcontrol as jlc
from x2i_torch.core import config as tcfg
from x2i_torch.diffusion.sampling import prepare_latent_image_ids
from x2i_torch.models.controlnext import ControlBank
from x2i_torch.params import load_flax_bank
from x2i_torch.pipeline import build_random_pipeline
from x2i_torch.train import harness as tharness
from x2i_torch.train.optim8bit import AdamW8bit


@pytest.fixture(scope="module")
def jax_lightcontrol():
    """JAX's phase-2 trainer at the configs of its ``build_tiny_lightcontrol``
    (the harness's flax inits take a minute on the CPU, so the weights are
    ``random_tree``s): -> (make(k) -> JAX's step_fn and optimizer with k
    mini-steps, the numpy trees {"flux", "vae", "bank"})."""
    flux_cfg = jcfg.tiny_flux_config(guidance_embeds=True, in_channels=16)
    vae_cfg = jcfg.VAEConfig(block_out_channels=(8, 8, 8, 8),
                             layers_per_block=1, latent_channels=4,
                             norm_num_groups=4, dtype=jnp.float32,
                             param_dtype=jnp.float32)
    ctrl_cfg, _ = ctrl_cfgs(final=flux_cfg.inner_dim)
    flux, vae = JFlux(flux_cfg), JVAE(vae_cfg)
    trees = {
        "flux": random_tree(
            functools.partial(flux.init, guidance=jnp.ones((1,))),
            jnp.zeros((1, 4, 16)), jnp.zeros((1, 8, 64)), jnp.zeros((1, 32)),
            jnp.zeros((1,)), prepare_latent_image_ids(4, 4).numpy(),
            jnp.zeros((8, 3)), seed=10),
        "vae": random_tree(vae.init, jnp.zeros((1, 32, 32, 3)), seed=11),
        "bank": bank_tree(ctrl_cfg, 32, flux_cfg.num_layers, seed=12)}

    def vae_encode(pixels, rng):
        return vae.apply(trees["vae"], pixels, rng, method=vae.encode)

    def make(accumulate):
        ccfg = jcfg.LightControlConfig(
            gradient_accumulation_steps=accumulate, learning_rate=1e-3)
        opt = jlc.make_lightcontrol_optimizer(ccfg)
        step_fn = jlc.make_lightcontrol_step(
            flux.apply, vae_encode, lambda b: (b["pooled"], b["prompt"]),
            ctrl_cfg, flux_cfg, ccfg, jcfg.SchedulerConfig(shift=3.0), opt)
        return jax.jit(step_fn), opt

    return make, trees


def _draws(key, bsz=2, latent=(4, 4, 4)):
    """Step ``key``'s draws as JAX's step_fn splits and draws them."""
    r_vae, r_t, r_noise = jax.random.split(key, 3)
    c, h, w = latent
    return {"vae": t(jax.random.normal(r_vae, (bsz, h, w, c), jnp.float32)),
            "density": t(jax.random.normal(r_t, (bsz,))),
            "noise": t(jax.random.normal(r_noise, (bsz, c, h, w),
                                         jnp.float32))}


def _bank_params(tree, like):
    return [p.detach() for p in
            load_flax_bank(ControlBank(like.cfg, len(like.branches)),
                           tree).parameters()]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_tiny_step_matches_jax(jax_lightcontrol, accumulate):
    """``build_tiny_lightcontrol`` on JAX's weights against JAX's step_fn
    on its batch: loss, grad norm and the updated bank after each step
    (three steps; with ``gradient_accumulation_steps=2`` four mini-steps
    against optax.MultiSteps, the bank unchanged by the first and
    third); the DiT and the VAE unchanged bit for bit."""
    make, trees = jax_lightcontrol
    jstep, opt = make(accumulate)
    bank = jax.tree_util.tree_map(jnp.asarray, trees["bank"])
    jstate = jlc.ControlTrainState(bank, opt.init(bank),
                                   jnp.zeros((), jnp.int32))
    step, state, batch, parts = tharness.build_tiny_lightcontrol(
        batch_size=2, trees=trees, device="cpu",
        gradient_accumulation_steps=accumulate)
    jbatch = {k: jnp.asarray(n(v)) for k, v in batch.items()}
    frozen = {k: v.clone() for m in (parts["flux"], parts["vae"])
              for k, v in m.state_dict().items()}
    for i in range(4 if accumulate > 1 else 3):
        before = [p.detach().clone() for p in state.bank.parameters()]
        jstate, jm = jstep(jstate, trees["flux"], jbatch, jax.random.key(i))
        state, m = step(state, batch, _draws(jax.random.key(i)))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(n(m[key]), n(jm[key]), **TOL)
        for got, want in zip(state.bank.parameters(),
                             _bank_params(jstate.params, state.bank)):
            np.testing.assert_allclose(n(got), n(want), **TOL)
        moved = any(not torch.equal(p, b) for p, b in
                    zip(state.bank.parameters(), before))
        assert moved == ((i + 1) % accumulate == 0)
    assert state.step == int(jstate.step) == i + 1
    assert state.opt_state.count == (i + 1) // accumulate
    now = {k: v for mod in (parts["flux"], parts["vae"])
           for k, v in mod.state_dict().items()}
    assert all(torch.equal(v, now[k]) for k, v in frozen.items())


def test_tiny_batch_is_the_jax_harness_batch():
    """The port's tiny batch is the JAX harness's (the same numpy draws;
    the harness's source is read, not run: its flax inits take a minute
    on the CPU)."""
    src = inspect.getsource(jharness.build_tiny_lightcontrol)
    assert "rng.standard_normal((B, PX, PX, 3))" in src
    _, _, batch, parts = tharness.build_tiny_lightcontrol(batch_size=3,
                                                          device="cpu")
    rng = np.random.default_rng(0)
    want = [rng.standard_normal((3, 32, 32, 3)),
            rng.standard_normal((3, 8, 64)), rng.standard_normal((3, 32))]
    for k, w in zip(("style_pixels", "prompt", "pooled"), want):
        np.testing.assert_array_equal(n(batch[k]), w.astype(np.float32))
    assert parts["ccfg"].learning_rate == 1e-3
    assert parts["sched_cfg"].shift == 3.0


def test_step_takes_a_seed_and_refuses_what_is_not_ported():
    """An int seeds the step's draws on the device (the same int, the same
    step); 8-bit AdamW builds, with f8 moments (train/optim8bit.py, its
    step in tests/test_torch_optim8bit.py and test_torch_runner.py); a
    glue kernel reached under autograd raises instead of giving way to the
    plain glue."""
    outs = []
    for _ in range(2):
        step, state, batch, _ = tharness.build_tiny_lightcontrol(
            batch_size=2, device="cpu")
        state, m = step(state, batch, 11)
        outs.append((float(m["loss"]), [p.detach().clone()
                                        for p in state.bank.parameters()]))
    assert np.isfinite(outs[0][0]) and outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    _, state8, _, parts8 = tharness.build_tiny_lightcontrol(
        batch_size=1, device="cpu", use_8bit_adam=True)
    assert isinstance(parts8["optimizer"], AdamW8bit)
    assert state8.opt_state.mu[0].dtype == torch.float8_e4m3fn
    step, state, batch, parts = tharness.build_tiny_lightcontrol(
        batch_size=1, device="cpu")
    parts["flux"].replace_config(fused_glue=True)
    with pytest.raises(RuntimeError, match="backward|autograd|grad"):
        step(state, {k: v[:1] for k, v in batch.items()}, 0)


def test_random_lightcontrol_on_a_pipeline():
    """The card's harness on the tiny pipeline at 64^2 (two branches, its
    DiT's width): the DiT set to the trainer's config and frozen with the
    pipeline's other modules, the conditioning taken from the pipeline's
    encode (inference tensors copied out), a step moves the bank alone."""
    pipe = build_random_pipeline(device="cpu", dtype=torch.float32)
    ccfg = tcfg.LightControlConfig(num_controls=pipe.flux.cfg.num_layers,
                                   gradient_accumulation_steps=1,
                                   learning_rate=1e-3)
    step, state, batch, parts = tharness.build_random_lightcontrol(
        "full", 0, pipe=pipe, device="cpu", ccfg=ccfg, px=64)
    cfg = pipe.flux.cfg
    assert (cfg.remat, cfg.rope_in_kernel, cfg.fused_glue) == (True, False,
                                                              False)
    assert state.bank.cfg.final_out_channels == cfg.inner_dim
    frozen = {k: v.clone() for m in (pipe.flux, pipe.vae, pipe.proj)
              for k, v in m.state_dict().items()}
    assert not any(p.requires_grad for m in (pipe.flux, pipe.vae, pipe.proj)
                   for p in m.parameters())
    before = [p.detach().clone() for p in state.bank.parameters()]
    state, m = step(state, batch, 0)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert any(not torch.equal(p, b) for p, b in
               zip(state.bank.parameters(), before))
    now = {k: v for m in (pipe.flux, pipe.vae, pipe.proj)
           for k, v in m.state_dict().items()}
    assert all(torch.equal(v, now[k]) for k, v in frozen.items())
