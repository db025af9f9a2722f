"""The port's distillation trainer against the JAX package's on the CPU
(the helpers and the tolerance of test_torch_distill.py, which holds the
tiny FLUX's KD outputs and gradients): the tiny trainer
(``build_tiny_distill``) for three steps against the JAX harness (loss,
grad_norm and the proj's parameters after each step, also with inline KD
and int8 KD stacks), the split step against the colocated one and the
TrainLoop, and ``DistillOptimizer``'s accumulation against optax."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_distill import TOL, n
from test_torch_params import one_thread  # noqa: F401 (autouse)
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion import sampling as jsamp
from x2i_tpu.train import distill as jdistill
from x2i_tpu.train import harness as jharness
from x2i_torch.core import config as tcfg
from x2i_torch.models.proj import Proj
from x2i_torch.params import load_flax
from x2i_torch.train import distill as tdistill
from x2i_torch.train import harness as tharness
from x2i_torch.train.runner import TrainLoop


@pytest.fixture(scope="module")
def jax_trainer():
    step_fn, state, flux_params, batch = jharness.build_tiny_distill(
        batch_size=2)
    parts = jharness.build_tiny_distill.last_parts
    tv = inspect.getclosurevars(parts["teacher_text_fn"]).nonlocals
    sv = inspect.getclosurevars(parts["student_states_fn"]).nonlocals
    to_np = (lambda tree: jax.tree_util.tree_map(np.asarray, tree))
    trees = {"flux": to_np(flux_params), "t5": to_np(tv["t5_params"]),
             "clip": to_np(tv["clip_params"]), "lm": to_np(sv["lm_params"]),
             "proj": to_np(state.params)}
    return state, flux_params, batch, parts, trees


def _latents(i):
    """Step i's noise: the JAX teacher's draw from key(i), packed."""
    lat = jax.random.normal(jax.random.key(i), (2, 16, 8, 8), jnp.float32)
    return np.asarray(jsamp.pack_latents(lat))


def _proj_params(tree, like):
    """The proj's parameters of a JAX tree, in the port's layout."""
    mod = load_flax(Proj(like.cfg), tree)
    return [p.detach() for p in mod.parameters()]


@pytest.mark.parametrize("variant", ["default", "inline_kd",
                                     "kd_stacks_int8"])
def test_tiny_trainer_three_steps_match_jax(jax_trainer, variant):
    jstate, flux_params, jbatch, parts, trees = jax_trainer
    changes = {} if variant == "default" else {variant: True}
    dcfg = dataclasses.replace(parts["dcfg"], **changes)
    jstep = jax.jit(jdistill.make_distill_step(
        parts["flux_apply"], parts["proj_apply"], parts["teacher_text_fn"],
        parts["student_states_fn"], parts["optimizer"], parts["flux_cfg"],
        dcfg))
    step, state, batch, tparts = tharness.build_tiny_distill(
        batch_size=2, trees=trees, device="cpu", **changes)
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(),
                                      np.asarray(jbatch[k]))
    for i in range(3):
        jstate, jm = jstep(jstate, flux_params, jbatch, jax.random.key(i))
        state, m = step(state, batch, torch.from_numpy(np.array(_latents(i))))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(n(m[key]), n(jm[key]), **TOL)
        for (name, got), want in zip(
                state.proj.named_parameters(),
                _proj_params(jstate.params, state.proj)):
            if name == "conv.bias":
                # it shifts every feature of a row alike, which the
                # LayerNorm after it removes: its gradient is zero up to
                # rounding, and Adam scales that noise to +-lr per step
                lr = dcfg.learning_rate
                assert np.abs(n(got) - n(want)).max() <= 2 * lr * (i + 1)
                continue
            np.testing.assert_allclose(n(got), n(want), **TOL)
    assert state.step == 3 and state.opt_state.count == 3


def test_split_step_equals_colocated_and_the_loop_runs(jax_trainer):
    """The slim split (the teacher hands over only the KD stacks; the
    student regenerates the latents and reads the MLLM states from the
    batch) gives the colocated step's numbers; the TrainLoop drives either
    with per-step seeds and times them."""
    trees = jax_trainer[4]
    step, state, batch, _ = tharness.build_tiny_distill(
        batch_size=2, trees=trees, device="cpu")
    (teacher_fn, student_fn), sstate, _, _ = tharness.build_tiny_distill(
        batch_size=2, trees=trees, device="cpu", split=True,
        slim_handoff=True)
    for i in range(2):
        lat = torch.from_numpy(np.array(_latents(i)))
        state, m = step(state, batch, lat)
        sstate, sm = student_fn(sstate, batch, teacher_fn(batch, lat), lat)
        assert set(teacher_fn(batch, lat)) == {"teacher_aux"}
        for key in m:
            np.testing.assert_allclose(n(sm[key]), n(m[key]), atol=1e-6,
                                       rtol=1e-6)
    seen = []
    loop = TrainLoop(step, state, iter(lambda: batch, None), seed=3,
                     on_metrics=lambda s, m: seen.append(s))
    out = loop.run(5)
    assert seen == [2, 3, 4] and out["timing"]["steps"] == 2
    assert np.isfinite(out["loss"]) and loop.state.step == 5


@pytest.mark.parametrize("accumulate", [1, 2, 3])
def test_optimizer_accumulation_matches_optax(accumulate):
    """DistillOptimizer against the JAX ``make_optimizer`` (optax's
    MultiSteps over its chain when accumulating) over six mini-steps of
    random gradients, one above the clip norm: the parameters after each
    mini-step (moved only on every ``accumulate``-th, from the second
    update on: the schedule's first learning rate is 0) and the count of
    updates."""
    dcfg = tcfg.DistillConfig(gradient_accumulation_steps=accumulate,
                              lr_warmup_steps=1, max_train_steps=10,
                              learning_rate=1e-2)
    jopt = jdistill.make_optimizer(jcfg.DistillConfig(
        gradient_accumulation_steps=accumulate, lr_warmup_steps=1,
        max_train_steps=10, learning_rate=1e-2))
    rng = np.random.default_rng(accumulate)
    shapes = ((3, 5), (7,), (2, 2, 2))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    opt = tdistill.make_optimizer(dcfg)
    tparams = [torch.tensor(p) for p in params]
    state = opt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for i in range(6):
        scale = 3.0 if i == 1 else 0.1
        grads = [scale * rng.standard_normal(s).astype(np.float32)
                 for s in shapes]
        updates, jstate = jupdate([jnp.asarray(g) for g in grads], jstate,
                                  jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        before = [p.clone() for p in tparams]
        state = opt.update(tparams, [torch.tensor(g) for g in grads], state)
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(n(got), n(want), atol=1e-6,
                                       rtol=1e-6)
        moved = any(not torch.equal(a, b) for a, b in zip(tparams, before))
        assert moved == (i > accumulate - 1 and (i + 1) % accumulate == 0)
    assert state.count == 6 // accumulate
