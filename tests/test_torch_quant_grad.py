"""The straight-through backward of the port's quantized layers
(``x2i_torch/ops/quant.py``: ``StraightThrough``, the dequantize plain
versions of ``ops/int8_gemm.py`` and ``ops/int4_gemm.py``) against the
JAX package's ``custom_vjp``s on the CPU, on the same quantized trees and
numpy inputs:

* ``QuantLinear``'s dx in w8a8, w8, w4 and w4a8, float32 and bf16,
  against ``jax.grad`` through ``QuantDense``; nothing else gets a
  gradient, the graph keeps only the codes and scales, and the forward
  under autograd is the one without it bit for bit;
* the pre-quantized chunk input raises under autograd;
* the plain dequantize versions bit for bit the JAX backwards' dequantize;
* the tiny w8a8 distillation step (inline KD, int8 teacher stacks): its
  loss and proj gradient against JAX's tiny step on the quantized tree.

Tolerances: float32 dx within 2e-5 (relative to the largest value: the
f32 product sums in another order); bf16 dx within one bf16 step of the
largest value (2^-7: f32 sums in another order, each rounded once to
bf16); the dequantize bit for bit (one rounding of a product that is
exact in f32); the tiny step's loss and gradient norm 1e-4, the bar of
test_torch_distill.py, and its proj gradient within relative L2 5e-3:
activation codes flip where the f32 sums of the two packages, taken in
another order, cross a rounding boundary, the w8a8 class of
tests/test_torch_quant.py's tiny-FLUX bar (1.3e-3 at its seed 6; 9.5e-4
measured here), while a backward that reaches x through the
activation's absmax alone, with no straight-through estimate, is about
1.0 away at a single layer."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_distill import TOL, n
from x2i_tpu.models import flux as jflux
from x2i_tpu.ops import quant as jq
from x2i_tpu.diffusion import sampling as jsamp
from x2i_tpu.train import distill as jdistill
from x2i_tpu.train import harness as jharness
from x2i_torch.models.proj import Proj
from x2i_torch.ops import int4_gemm as t4
from x2i_torch.ops import int8_gemm as tgemm
from x2i_torch.ops import quant as tq
from x2i_torch.params import load_flax
from x2i_torch.train import harness as tharness

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
MODES = ("w8a8", "w8", "w4", "w4a8")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny steps' small ops on one thread: with the test run's
    workers on every core, torch's thread pool made them ten times
    slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_grid(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _pair(rng, mode, dtype, k=256, nout=48):
    """A QuantDense (JAX) and a QuantLinear (port) on the same
    ``quantize_tree`` leaves (w4 with an AWQ pre-scale), through the
    bridge."""
    jdt, tdt = DTYPES[dtype]
    w = rng.standard_normal((k, nout)).astype(np.float32) / np.sqrt(k)
    leaves = jq.quantize_tree({"d": {"kernel": w}}, mode)["d"]
    if mode == "w4":
        leaves["pre_scale"] = rng.uniform(0.5, 2.0, k).astype(np.float32)
    leaves["bias"] = bf16_grid(rng.standard_normal(nout) * 0.1)
    dense = jq.QuantDense(nout, dtype=jdt, param_dtype=jdt, mode=mode)
    layer = tq.QuantLinear(k, nout, mode=mode, dtype=tdt)
    load_flax(torch.nn.ModuleDict({"d": layer}), {"d": leaves})
    return dense, {"params": leaves}, layer


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_quant_linear_dx_matches_jax_grad(mode, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(MODES.index(mode))
    dense, params, layer = _pair(rng, mode, dtype)
    x = bf16_grid(rng.standard_normal((2, 9, 256)) * 2.0)
    dy = bf16_grid(rng.standard_normal((2, 9, 48)))

    @jax.jit
    def jgrad(p, x, dy):
        return jax.grad(lambda x: jnp.vdot(
            dense.apply(p, x).astype(jnp.float32), dy))(x)

    want = n(jgrad(params, jnp.asarray(x, jdt), jnp.asarray(dy)))
    xt = torch.tensor(x).to(tdt).requires_grad_()
    y = layer(xt)
    # the graph keeps the layer's codes and scales, no float weight
    saved = y.grad_fn.saved_tensors
    assert [t.data_ptr() for t in saved] == [t.data_ptr()
                                             for t in layer.codes()]
    assert {t.dtype for t in saved} <= {torch.int8, torch.float32}
    y.backward(torch.tensor(dy).to(tdt))
    assert xt.grad.dtype == tdt
    scale = np.abs(want).max()
    tol = 2.0 ** -7 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(n(xt.grad), want, rtol=0, atol=tol * scale)
    # the forward under autograd is the forward without it
    with torch.no_grad():
        assert torch.equal(y.detach(), layer(xt.detach()))
    # nothing but x gets a gradient
    assert all(b.grad is None and not b.requires_grad
               for b in layer.buffers())
    assert layer.bias.grad is None


def test_quant_linear_takes_the_plain_product_without_autograd():
    """Under no_grad, or on an input that needs no gradient, no graph is
    built: the product is the plain one."""
    rng = np.random.default_rng(9)
    _, _, layer = _pair(rng, "w8a8", "f32")
    x = torch.randn(3, 256)
    assert layer(x).grad_fn is None
    with torch.no_grad():
        assert layer(x.requires_grad_()).grad_fn is None


def test_prequant_input_raises_under_autograd():
    rng = np.random.default_rng(4)
    _, _, layer = _pair(rng, "w8a8", "f32")
    x = torch.randn(2, 3, 256, requires_grad=True)
    pair = tq.quant_rows(x, impl="plain")
    with pytest.raises(RuntimeError, match="inference-only.*unfused"):
        layer(pair)
    with pytest.raises(RuntimeError, match="inference-only"):
        layer([(pair[0][..., :128], pair[1]), (pair[0][..., 128:], pair[1])])
    with torch.no_grad():
        assert layer(pair).shape == (2, 3, 48)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["int8", "w4a8"])
def test_dequantize_plain_versions_match_jax(kind, dtype):
    """The weight the backward multiplies by: bit for bit the JAX
    backwards' ``qk.astype(x_dtype) * scale.astype(x_dtype)`` and
    ``_w4a8_weight_int8(pk, m).astype(x_dtype) * scale.astype(x_dtype)``,
    transposed to the port's (out, in)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    w = rng.standard_normal((512, 96)).astype(np.float32) / 20
    if kind == "int8":
        qk, s = jq.quantize_kernel(w)
        want = jnp.asarray(qk).astype(jdt) * jnp.asarray(s).astype(jdt)
        got = tgemm.int8_dequant(torch.from_numpy(qk.T.copy()),
                                 torch.from_numpy(s), tdt)
    else:
        pk, m, s = jq.quantize_kernel_w4a8(w)
        want = (jq._w4a8_weight_int8(jnp.asarray(pk), jnp.asarray(m))
                .astype(jdt) * jnp.asarray(s).astype(jdt))
        got = t4.w4a8_dequant(torch.from_numpy(pk.T.copy()),
                              torch.from_numpy(m), torch.from_numpy(s), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(n(got), n(want).T)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's tiny distillation harness: its parts and its numpy trees."""
    _, state, flux_params, batch = jharness.build_tiny_distill(batch_size=2)
    parts = jharness.build_tiny_distill.last_parts
    tv = inspect.getclosurevars(parts["teacher_text_fn"]).nonlocals
    sv = inspect.getclosurevars(parts["student_states_fn"]).nonlocals
    to_np = (lambda tree: jax.tree_util.tree_map(np.asarray, tree))
    trees = {"flux": to_np(flux_params), "t5": to_np(tv["t5_params"]),
             "clip": to_np(tv["clip_params"]), "lm": to_np(sv["lm_params"]),
             "proj": to_np(state.params)}
    return parts, state.params, batch, trees


def test_tiny_w8a8_distillation_gradient_matches_jax(jax_tiny):
    """One step of the tiny trainer at the single-chip operating point
    (a w8a8 DiT, inline KD, int8 teacher stacks) on JAX's own noise: the
    loss and the proj's gradient against JAX's step on the
    ``quantize_tree`` of the same DiT (the port's DiT quantized in place
    by ``quantize_module_``, which gives the same leaves). The gradient
    is what each step hands its optimizer: JAX's through an identity
    transformation (the new params less the old), the port's caught at
    its optimizer's update."""
    parts, jparams, jbatch, trees = jax_tiny
    changes = dict(inline_kd=True, kd_stacks_int8=True)
    dcfg = dataclasses.replace(parts["dcfg"], **changes)
    jcfg_q = dataclasses.replace(parts["flux_cfg"], quantized="w8a8")
    identity = optax.GradientTransformation(
        lambda p: optax.EmptyState(), lambda g, s, p=None: (g, s))
    jstep = jax.jit(jdistill.make_distill_step(
        jflux.FluxTransformer2D(jcfg_q).apply, parts["proj_apply"],
        parts["teacher_text_fn"], parts["student_states_fn"], identity,
        jcfg_q, dcfg))
    qtree = jq.quantize_tree(trees["flux"], "w8a8")
    state0 = jdistill.TrainState(jparams, identity.init(jparams),
                                 jnp.zeros((), jnp.int32))
    jstate, jm = jstep(state0, qtree, jbatch, jax.random.key(0))
    jgrads = jax.tree_util.tree_map(lambda a, b: a - b, jstate.params,
                                    jparams)

    step, state, batch, tparts = tharness.build_tiny_distill(
        batch_size=2, trees=trees, device="cpu", **changes)
    tq.quantize_module_(tparts["flux"], "w8a8")
    caught = {}

    def update(params, grads, opt_state):
        caught["grads"] = grads
        return opt_state

    tparts["optimizer"].update = update
    lat = jax.random.normal(jax.random.key(0), (2, 16, 8, 8), jnp.float32)
    lat = torch.from_numpy(np.array(jsamp.pack_latents(lat)))
    _, m = step(state, batch, lat)
    np.testing.assert_allclose(n(m["loss"]), n(jm["loss"]), **TOL)
    np.testing.assert_allclose(n(m["grad_norm"]), n(jm["grad_norm"]), **TOL)
    want = [p.detach() for p in load_flax(Proj(state.proj.cfg),
                                          jgrads).parameters()]
    got = torch.cat([g.flatten() for g in caught["grads"]]).numpy()
    want = torch.cat([w.flatten() for w in want]).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 5e-3, rel
