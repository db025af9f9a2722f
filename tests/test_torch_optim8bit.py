"""The port's 8-bit AdamW (``x2i_torch/train/optim8bit.py``) against the
JAX package's (``x2i_tpu/train/optim8bit.py``) on the CPU, on the same
numpy parameters and gradients:

* the codec bit for bit (codes, scales and the values decoded): blocks
  whose largest ratio reaches 448 up to an ulp (both casts give 448), a
  zero block, a 1000-element tensor (not a multiple of 128), a 3-d one;
* three updates of phase 1's chain (``make_optimizer`` with
  ``use_8bit_adam``: clip, 8-bit AdamW on the warmup-cosine schedule)
  against optax's, alone and in ``MultiSteps(k=2)``, one mini-step above
  the clip norm: the parameters after each mini-step, and the codes and
  scales of the moments bit for bit;
* phase 2's 8-bit optimizer: JAX's ``adamw8bit(learning_rate)``, whose
  weight decay is 1e-2 (the 32-bit path's optax adamw has 1e-4);
* the state's bytes: f8 codes and f32 block scales, about 3.9x fewer than
  two f32 moments, as many as JAX's state holds.

Tolerance: the parameters within 2e-5 (the update's f32 arithmetic in
another order: the bias corrections' powers and the schedule's
learning rate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x2i_tpu.core import config as jcfg
from x2i_tpu.train import distill as jdistill
from x2i_tpu.train import lightcontrol as jlc
from x2i_tpu.train import optim8bit as j8
from x2i_torch.core import config as tcfg
from x2i_torch.train import distill as tdistill
from x2i_torch.train import lightcontrol as tlc
from x2i_torch.train import optim8bit as t8
from x2i_torch.train.optim import AdamW

TOL = dict(atol=2e-5, rtol=2e-5)
SHAPES = ((3, 5), (7,), (2, 2, 2), (300,))


def _boundary_blocks(rng):
    """Six blocks of 128: four whose absmax a has f32(a / f32(a / 448))
    = 448.00003 (two positive, two negative), a zero block, and an
    ordinary one."""
    a = rng.uniform(0.1, 10.0, 100_000).astype(np.float32)
    hits = a[a / (a / np.float32(448.0)) > 448.0][:4]
    assert len(hits) == 4
    x = rng.standard_normal((6, 128)).astype(np.float32)
    for i, h in enumerate(hits):
        x[i] *= 0.5 * h / np.abs(x[i]).max()
        x[i, 5 + i] = h if i % 2 else -h
    x[4] = 0.0
    return x


def _codes(q):
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


@pytest.mark.parametrize("case", ["boundary", "1000", "3-d"])
def test_codec_bit_for_bit(case):
    rng = np.random.default_rng(1)
    x = {"boundary": lambda: _boundary_blocks(rng),
         "1000": lambda: rng.standard_normal(1000).astype(np.float32) * 1e-3,
         "3-d": lambda: rng.standard_normal((5, 7, 9)).astype(np.float32)
         }[case]()
    q, s = j8._quantize(jnp.asarray(x))
    tq, ts = t8._quantize(torch.tensor(x))
    assert tq.dtype == torch.float8_e4m3fn and ts.dtype == torch.float32
    assert tq.shape == q.shape == (-(-x.size // 128), 128)
    np.testing.assert_array_equal(_codes(tq), _codes(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    back = t8._dequantize(tq, ts, x.shape)
    assert back.shape == x.shape
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(j8._dequantize(q, s, x.shape)))
    if case == "boundary":
        assert (np.abs(tq[:4].float().numpy()).max(1) == 448.0).all()
        assert not tq[4].float().any() and (ts[4] == 1e-30).all()


def _flat_state(jstate):
    """JAX's 8-bit state inside the chain (and MultiSteps): the
    Adam8bitState."""
    found = []

    def walk(node):
        if isinstance(node, j8.Adam8bitState):
            found.append(node)
        elif isinstance(node, tuple):
            for child in node:
                walk(child)
        elif hasattr(node, "inner_opt_state"):
            walk(node.inner_opt_state)

    walk(jstate)
    return found[0]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_three_updates_match_optax(accumulate):
    kw = dict(gradient_accumulation_steps=accumulate, lr_warmup_steps=1,
              max_train_steps=10, learning_rate=1e-2, use_8bit_adam=True)
    jopt = jdistill.make_optimizer(jcfg.DistillConfig(**kw))
    opt = tdistill.make_optimizer(tcfg.DistillConfig(**kw))
    assert isinstance(opt, t8.Moments8bit)
    rng = np.random.default_rng(accumulate)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    tparams = [torch.tensor(p) for p in params]
    state = opt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for i in range(3 * accumulate):
        scale = 3.0 if i == 1 else 0.1
        grads = [scale * rng.standard_normal(s).astype(np.float32)
                 for s in SHAPES]
        updates, jstate = jupdate([jnp.asarray(g) for g in grads], jstate,
                                  jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        state = opt.update(tparams, [torch.tensor(g) for g in grads], state)
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert state.count == 3 and state.mini_step == 0
    inner = _flat_state(jstate)
    for key in ("mu", "nu"):
        for got, want in zip(getattr(state, key), getattr(inner, key + "_q")):
            np.testing.assert_array_equal(_codes(got), _codes(want))
        for got, want in zip(getattr(state, key + "_scale"),
                             getattr(inner, key + "_scale")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)


def test_phase2_8bit_weight_decay_is_jax_adamw8bits():
    """With zero gradients the moments stay 0 and an update is the weight
    decay alone: p <- p - lr * 1e-2 * p, as JAX's ``adamw8bit`` default;
    the 32-bit path decays by 1e-4."""
    kw = dict(gradient_accumulation_steps=1, learning_rate=1e-1)
    opt = tlc.make_lightcontrol_optimizer(tcfg.LightControlConfig(
        use_8bit_adam=True, **kw))
    jopt = jlc.make_lightcontrol_optimizer(jcfg.LightControlConfig(
        use_8bit_adam=True, **kw))
    assert isinstance(opt, t8.AdamW8bit) and opt.weight_decay == 1e-2
    assert type(tlc.make_lightcontrol_optimizer(tcfg.LightControlConfig(
        **kw))) is AdamW
    p0 = np.random.default_rng(3).standard_normal((4, 33)).astype(np.float32)
    tparams, jparams = [torch.tensor(p0)], [jnp.asarray(p0)]
    state, jstate = opt.init(tparams), jopt.init(jparams)
    zero = [np.zeros_like(p0)]
    for _ in range(2):
        state = opt.update(tparams, [torch.tensor(z) for z in zero], state)
        updates, jstate = jopt.update([jnp.asarray(z) for z in zero], jstate,
                                      jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
    np.testing.assert_allclose(tparams[0].numpy(), np.asarray(jparams[0]),
                               **TOL)
    np.testing.assert_allclose(tparams[0].numpy(), p0 * (1 - 1e-3) ** 2,
                               rtol=1e-6)


def test_state_bytes():
    params = [torch.zeros(128 * 1000), torch.zeros(1000)]
    state = t8.AdamW8bit(1e-3, 1.0).init(params)
    blocks = 1000 + 8
    assert t8.state_bytes(state) == 2 * (blocks * 128 + blocks * 4)
    jstate = j8.adamw8bit(1e-3).init([jnp.zeros(128 * 1000),
                                      jnp.zeros(1000)])
    assert t8.state_bytes(state) == sum(
        np.asarray(leaf).nbytes for leaf in jax.tree_util.tree_leaves(
            (jstate.mu_q, jstate.mu_scale, jstate.nu_q, jstate.nu_scale)))
    dense = AdamW(1e-3, 1.0).init(params)
    assert t8.state_bytes(dense) == 2 * 4 * 129_000
    ratio = t8.state_bytes(dense) / t8.state_bytes(state)
    assert 3.85 < ratio < 3.9
