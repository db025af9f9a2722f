"""The port's distillation path against the JAX package's on the CPU, in
float32 at tiny sizes, on the same weights (through the bridge) and the
same numpy inputs and noise latents:

* the tiny FLUX's KD outputs: aux stacks in both layouts (dense and int8),
  inline KD against JAX's and against the two-pass loss, gradients with
  respect to the conditioning against jax.grad (also on the kernel route,
  the JAX side's Pallas kernels in interpret mode), remat on against off;
Tolerance 1e-4 (absolute and relative) unless stated: float32 sums in
another order through a few blocks and an optimizer step.

The tiny trainer is in test_torch_distill_trainer.py, with these helpers
and bars, so that the test runner's workers take both files at once."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import flux_tree, one_thread
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion import sampling as jsamp
from x2i_tpu.models import flux as jflux
from x2i_torch.core import config as tcfg
from x2i_torch.models import flux as tflux
from x2i_torch.ops.kd import quantize_kd_stacks
from x2i_torch.params import load_flax
from x2i_torch.train import distill as tdistill

jattn = importlib.import_module("x2i_tpu.ops.attention")
TOL = dict(atol=1e-4, rtol=1e-4)
KEYS = ("double_img", "double_txt", "single")


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(cfg, s_img=16, s_txt=8, seed=0):
    rng = np.random.default_rng(seed)
    grid = int(2 * s_img ** 0.5)
    return [rng.standard_normal((1, s_img, cfg.in_channels)),
            rng.standard_normal((1, s_txt, cfg.joint_attention_dim)),
            rng.standard_normal((1, cfg.pooled_projection_dim)),
            np.array([1.0]),
            np.asarray(jsamp.prepare_latent_image_ids(grid, grid)),
            np.zeros((s_txt, 3))]


def _both(jc, tc, s_img=16, s_txt=8, seed=0):
    tree = flux_tree(seed, jc, s_img, s_txt)
    args = [np.asarray(a, np.float32) for a in _inputs(jc, s_img, s_txt,
                                                      seed)]
    return (jflux.FluxTransformer2D(jc), tree,
            load_flax(tflux.FluxTransformer2D(tc), tree), args)


def _tt(args):
    return [torch.from_numpy(np.array(a)) for a in args]


@pytest.mark.parametrize("layout", ["reference", "scan"])
@pytest.mark.parametrize("quantized", [False, True])
def test_flux_aux_stacks_match_jax(layout, quantized):
    jm, tree, model, args = _both(jcfg.tiny_flux_config(),
                                  tcfg.tiny_flux_config())
    kw = dict(return_attn_outputs=True, quantize_attn_outputs=quantized,
              aux_layout=layout)
    want_out, want = jm.apply(tree, *(jnp.asarray(a) for a in args), **kw)
    with torch.no_grad():
        got_out, got = model(*_tt(args), **kw)
    np.testing.assert_allclose(n(got_out), n(want_out), **TOL)
    lead = {"reference": (1, None), "scan": (None, 1)}[layout]
    for key, layers in zip(KEYS, (2, 2, 4)):
        g, w = got[key], want[key]
        if quantized:
            # scales within tolerance, int8 codes within one step and at
            # most 0.1% flipped (a value at a rounding boundary may land on
            # either side)
            assert g[0].dtype == torch.int8
            np.testing.assert_allclose(n(g[1]), n(w[1]), **TOL)
            flips = np.abs(n(g[0]) - n(w[0]))
            assert flips.max() <= 1 and flips.mean() <= 1e-3
            g, w = g[0], w[0]
        else:
            np.testing.assert_allclose(n(g), n(w), **TOL)
        assert g.shape[:2] == tuple(layers if d is None else d for d in lead)


def _teacher_stacks(jm, tree, args):
    """JAX teacher stacks (scan layout) on other conditioning, as numpy:
    fed to both packages."""
    rng = np.random.default_rng(9)
    targs = list(args)
    targs[1] = rng.standard_normal(args[1].shape).astype(np.float32)
    targs[2] = rng.standard_normal(args[2].shape).astype(np.float32)
    _, aux = jm.apply(tree, *(jnp.asarray(a) for a in targs),
                      return_attn_outputs=True, aux_layout="scan")
    return {k: np.array(v) for k, v in aux.items()}


def _grads_vs_jax(jc, tc, s_img, s_txt, kd=True, monkeypatch=None):
    """jax.grad and torch.autograd of the loss with respect to the text
    sequence and the pooled conditioning: the inline KD loss against
    teacher stacks, or (kd=False) sum(output * w)."""
    jm, tree, model, args = _both(jc, tc, s_img, s_txt)
    w = np.random.default_rng(7).standard_normal(
        (1, s_img, jc.in_channels)).astype(np.float32)
    teacher = _teacher_stacks(jm, tree, args) if kd else None

    def jloss(txt, pooled):
        a = [jnp.asarray(x) for x in args]
        a[1], a[2] = txt, pooled
        if kd:
            return jm.apply(tree, *a, kd_targets={
                k: jnp.asarray(v) for k, v in teacher.items()},
                aux_layout="scan")[1]
        return jnp.sum(jm.apply(tree, *a) * jnp.asarray(w))

    if monkeypatch is not None:
        monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
            jnp.asarray(args[1]), jnp.asarray(args[2]))
    targs = _tt(args)
    targs[1].requires_grad_()
    targs[2].requires_grad_()
    if kd:
        loss = model(*targs, kd_targets={k: torch.from_numpy(v)
                                         for k, v in teacher.items()},
                     aux_layout="scan")[1]
    else:
        loss = (model(*targs) * torch.from_numpy(w)).sum()
    loss.backward()
    return (loss, targs[1].grad, targs[2].grad), (want[0], *want[1])


def test_flux_inline_kd_and_its_gradients_match_jax():
    got, want = _grads_vs_jax(jcfg.tiny_flux_config(),
                              tcfg.tiny_flux_config(), 16, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)


def test_flux_kernel_route_gradients_match_jax_interpret(monkeypatch):
    """head_dim 64 at 128 joint tokens, rope in the kernel: the JAX side
    differentiates through its custom_vjp (forward with lse, K3 and K4 in
    interpret mode), the port through its flash Function (the kernels'
    plain versions on the CPU)."""
    kw = dict(attention_head_dim=64, axes_dims_rope=(16, 24, 24),
              num_layers=1, num_single_layers=1)
    got, want = _grads_vs_jax(
        jcfg.tiny_flux_config(use_pallas_attention=True, **kw),
        tcfg.tiny_flux_config(attention_impl="kernel", **kw), 64, 64,
        kd=False, monkeypatch=monkeypatch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)


def test_inline_kd_equals_two_pass_and_remat_changes_nothing():
    """Inline per-block KD = kd_loss over the returned stacks (int8
    teacher stacks too); remat on gives the same loss and gradients as
    off, and the rope outside the kernel the same as inside (up to float32
    rounding)."""
    jm, tree, model, args = _both(jcfg.tiny_flux_config(),
                                  tcfg.tiny_flux_config())
    teacher = {k: torch.from_numpy(v)
               for k, v in _teacher_stacks(jm, tree, args).items()}

    def run(targets, **changes):
        model.replace_config(**{"remat": False, "rope_in_kernel": True,
                                **changes})
        targs = _tt(args)
        targs[1].requires_grad_()
        _, inline = model(*targs, kd_targets=targets, aux_layout="scan")
        inline.backward()
        with torch.no_grad():
            _, aux = model(*_tt(args), return_attn_outputs=True,
                           aux_layout="scan")
        two_pass = tdistill.kd_loss(targets, aux, 3.0, layout="scan")
        return inline, two_pass, targs[1].grad

    for targets in (teacher, quantize_kd_stacks(teacher)):
        base = run(targets)
        np.testing.assert_allclose(n(base[0]), n(base[1]), atol=1e-6,
                                   rtol=1e-6)
        for changes in ({"remat": True}, {"rope_in_kernel": False}):
            other = run(targets, **changes)
            for a, b in zip(base, other):
                np.testing.assert_allclose(n(a), n(b), atol=1e-6, rtol=1e-5)
