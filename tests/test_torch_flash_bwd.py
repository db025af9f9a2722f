"""The port's differentiable flash attention against the JAX package's on
the CPU, in float32: K1's lse output and the K3/K4 plain versions, through
the autograd ``Function``, against JAX ``_flash_forward(return_lse=True)``,
``_flash_backward`` and ``jax.grad`` of ``flash_attention``, the Pallas
kernels in interpret mode. Tolerance: atol and rtol 1e-4 (float32 sums in
another order; the lse is in log2 units).

Also the guard of every forward-only kernel wrapper: under autograd each
raises instead of returning a detached tensor, forced onto the kernel
wrappers on the CPU as the tests force the attention with
``implementation="kernel"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import one_thread  # noqa: F401 (autouse)

from x2i_tpu.ops import flash_attention as jfa
from x2i_torch.core import config as tcfg
from x2i_torch.models import flux as tflux
from x2i_torch.ops import attention as tattn
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.ops import fused_glue as tfg
from x2i_torch.ops import int8_gemm as tgemm
from x2i_torch.params import random_init_

TOL = dict(atol=1e-4, rtol=1e-4)

# (label, B, Hq, Hk, S, D, kv mask, causal, rope)
CASES = [
    ("plain", 1, 2, 2, 128, 64, False, False, False),
    ("mask-causal-gqa", 2, 4, 2, 128, 64, True, True, False),
    ("rope-gqa-d128", 1, 2, 1, 128, 128, False, False, True),
    ("rope-mask-causal-d64", 2, 2, 2, 128, 64, True, True, True),
]


def _case(b, hq, hk, s, d, masked, rope, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, s), bool)
        mask[:, s - 37:] = False
        mask[-1, 0] = False              # a row whose first key is masked
    tables = None
    if rope:
        ang = rng.uniform(0, 6.3, (s, d // 2)).astype(np.float32)
        tables = (np.concatenate([np.cos(ang)] * 2, -1),
                  np.concatenate([np.sin(ang)] * 2, -1))
    return q, k, v, do, mask, tables


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jrope(tables):
    if tables is None:
        return None
    cos, sin = (jnp.asarray(t) for t in tables)
    return cos, jfa._rope_signed_sin(sin)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_lse_and_backward_match_jax(case):
    _, b, hq, hk, s, d, masked, causal, rope = case
    q, k, v, do, mask, tables = _case(b, hq, hk, s, d, masked, rope)
    scale = 1.0 / np.sqrt(d)
    jmask = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jfa._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
            causal=causal, scale=scale, return_lse=True, rope=_jrope(tables))
        jgrads = jfa._flash_backward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, jo, jlse,
            jnp.asarray(do), causal=causal, scale=scale, rope=_jrope(tables))
    trope = None if tables is None else tuple(_t(x) for x in tables)
    o, lse = tfa.flash_forward_lse(_t(q), _t(k), _t(v), _t(mask), causal,
                                   scale, trope)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    # the backward on JAX's own residuals, so that it is held alone
    grads = tfa.flash_backward_plain(
        _t(q), _t(k), _t(v), _t(mask), _t(np.asarray(jo)),
        _t(np.asarray(jlse)), _t(do), causal, scale, trope)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_autograd_matches_jax_grad(case):
    """torch.autograd through ``flash_attention`` (the Function's CPU
    route: the plain K1-lse, K3 and K4) against jax.grad through the
    custom_vjp, the Pallas kernels in interpret mode."""
    _, b, hq, hk, s, d, masked, causal, rope = case
    q, k, v, do, mask, tables = _case(b, hq, hk, s, d, masked, rope, seed=1)
    jmask = None if mask is None else jnp.asarray(mask)
    jtab = None if tables is None else tuple(jnp.asarray(t) for t in tables)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, kv_mask=jmask, causal=causal,
                                rope=jtab)
        return jnp.sum(o * jnp.asarray(do))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    args = [_t(x).requires_grad_() for x in (q, k, v)]
    trope = None if tables is None else tuple(_t(x) for x in tables)
    o = tfa.flash_attention(*args, kv_mask=_t(mask), causal=causal,
                            rope=trope)
    assert o.grad_fn is not None
    (o * _t(do)).sum().backward()
    for got, w in zip(args, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), **TOL)


def test_long_rope_and_long_kv_routes_match_plain_autograd(monkeypatch):
    """Above ROPE_MAX_KV the rope is applied outside the kernels and
    autograd carries its transpose; above MAX_KV_SEQ the backward
    recomputes through the plain attention. Both equal autograd through
    the plain attention with the rope applied first (limits lowered so that
    the shapes stay small)."""
    rng = np.random.default_rng(4)
    b, h, s, d = 1, 2, 128, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                                    .astype(np.float32)) for _ in range(4))
    ang = torch.from_numpy(rng.uniform(0, 6.3, (s, d // 2))
                           .astype(np.float32))
    rope = (torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1))

    def grads(fn):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*args) * do).sum().backward()
        return [a.grad for a in args]

    want = grads(lambda q, k, v: tfa.xla_attention(
        tfa.rope_bhsd(q, *rope), tfa.rope_bhsd(k, *rope), v))
    for limits in ((64, 8192), (64, 64)):
        with monkeypatch.context() as mp:
            mp.setattr(tfa, "ROPE_MAX_KV", limits[0])
            mp.setattr(tfa, "MAX_KV_SEQ", limits[1])
            got = grads(lambda q, k, v: tfa.flash_attention(q, k, v,
                                                            rope=rope))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_qk_norm_above_rope_max_kv_matches_jax_grad(monkeypatch):
    """With qk_norm between ROPE_MAX_KV and MAX_KV_SEQ (lowered to 64 and
    256 in both packages, so that 128 tokens lie between them) a call that
    autograd records normalizes and rotates outside the kernels and is
    differentiable, as JAX's: the value and the q/k/v gradients against
    jax.grad of JAX's ``flash_attention``, the Pallas kernels in interpret
    mode."""
    monkeypatch.setattr(tfa, "ROPE_MAX_KV", 64)
    monkeypatch.setattr(tfa, "MAX_KV_SEQ", 256)
    monkeypatch.setenv("X2I_FA_ROPE_MAX_KV", "64")
    monkeypatch.setattr(jfa, "MAX_KV_SEQ", 256)
    b, h, s, d = 1, 2, 128, 64
    q, k, v, do, _, tables = _case(b, h, h, s, d, False, True, seed=6)
    rng = np.random.default_rng(7)
    qw, kw = (1.0 + 0.1 * rng.standard_normal(d).astype(np.float32)
              for _ in range(2))
    jtab = tuple(jnp.asarray(t) for t in tables)

    def jax_out(q, k, v):
        return jfa.flash_attention(q, k, v, rope=jtab, qk_norm=(
            jnp.asarray(qw), jnp.asarray(kw), 1e-6))

    with pltpu.force_tpu_interpret_mode():
        jargs = [jnp.asarray(x) for x in (q, k, v)]
        want_o = jax_out(*jargs)
        want = jax.grad(lambda *a: jnp.sum(jax_out(*a) * jnp.asarray(do)),
                        argnums=(0, 1, 2))(*jargs)
    args = [_t(x).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*args, rope=tuple(_t(x) for x in tables),
                            qk_norm=(_t(qw), _t(kw), 1e-6))
    assert o.grad_fn is not None
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), **TOL)
    (o * _t(do)).sum().backward()
    for got, w in zip(args, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("blocks,stages,sms,want", [
    (864, 72, 132, 1),        # FLUX: 36 kv tiles x 24 heads, no split
    (132, 8, 132, 1),
    (8, 56, 132, 14),         # the LM: 4 kv tiles x 2 kv heads, 7 x 8
    (8, 8, 132, 8),           # one stage per share
    (2, 3, 132, 3),
    (100, 40, 132, 2),
])
def test_dkv_splits(blocks, stages, sms, want):
    """K4's split of its (group x q tiles) stages at small grids: about one
    block per SM, every share non-empty."""
    splits = tfa.dkv_splits(blocks, stages, sms)
    assert splits == want
    per = -(-stages // splits)
    assert (splits - 1) * per < stages <= splits * per


def test_dispatcher_routes_carry_gradients():
    """The kernel route (flash Function), the pad-and-mask route and the
    plain route give the same gradients with respect to q, k and v."""
    rng = np.random.default_rng(5)
    for s in (128, 100):                  # 100: padded to 128 with a mask
        q, k, v, do = (torch.from_numpy(rng.standard_normal((2, s, 4, 64))
                                        .astype(np.float32))
                       for _ in range(4))

        def grads(impl):
            args = [t.clone().requires_grad_() for t in (q, k, v)]
            (tattn.attention(*args, implementation=impl) * do).sum(
            ).backward()
            return [a.grad for a in args]

        for g, w in zip(grads("kernel"), grads("plain")):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def _leaf(*shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)
                       ).requires_grad_()


def test_forward_only_kernels_refuse_grad():
    """K5-K8, the int8 GEMM and K1 with qk_norm raise under autograd,
    on the CPU as on the card; the same calls pass without grad, and the
    plain quantization route (impl="plain") stays differentiable."""
    x, e = _leaf(1, 8, 64), _leaf(1, 64)
    w = torch.ones(64)
    calls = {
        "ln_mod": lambda: tfg.ln_mod(x, e, e),
        "ln_mod_quant": lambda: tfg.ln_mod_quant(x, e, e),
        "gelu_quant": lambda: tfg.gelu_quant(x),
        "quant_rows": lambda: tfg.quant_rows(x),
        "int8 GEMM": lambda: tgemm.int8_linear(
            torch.ones((8, 64), dtype=torch.int8), torch.ones((8, 1)),
            torch.ones((16, 64), dtype=torch.int8), torch.ones(16),
            addend=_leaf(8, 16), out_dtype=torch.float32),
        "qk_norm": lambda: tattn.attention(
            _leaf(1, 128, 2, 64), x.new_ones(1, 128, 2, 64),
            x.new_ones(1, 128, 2, 64), implementation="kernel",
            rope=(torch.ones(128, 64), torch.zeros(128, 64)),
            qk_norm=(w, w, 1e-6)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
        with torch.no_grad():
            call()
    q, a = tfg.quant_rows(x, impl="plain")
    assert q.dtype == torch.int8 and a.requires_grad


def test_fused_glue_flux_refuses_grad_unfused_flux_trains():
    """A tiny FLUX with the fused glue on the kernel route raises on a
    forward that autograd records; unfused, the gradient reaches every
    q/k/v projection through the flash Function."""
    kw = dict(attention_head_dim=64, axes_dims_rope=(16, 24, 24),
              attention_impl="kernel")
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(1, 64, 64, generator=g),
            torch.randn(1, 64, 64, generator=g).requires_grad_(),
            torch.randn(1, 32, generator=g), torch.tensor([0.5]),
            torch.zeros(64, 3), torch.zeros(64, 3))
    fused = random_init_(tflux.FluxTransformer2D(
        tcfg.tiny_flux_config(fused_glue=True, **kw)), g)
    with pytest.raises(RuntimeError, match="has no backward"):
        fused(*args)
    model = random_init_(tflux.FluxTransformer2D(
        tcfg.tiny_flux_config(**kw)), g)
    model.requires_grad_(True)
    model(*args).square().mean().backward()
    blocks = [*model.double_blocks, *model.single_blocks]
    projs = [getattr(b, n) for b in blocks
             for n in ("q", "k", "v", "img_q", "img_k", "img_v", "txt_q",
                       "txt_k", "txt_v") if hasattr(b, n)]
    assert len(projs) == 3 * 2 * 2 + 3 * 4
    for lin in projs:
        assert lin.weight.grad is not None
        assert lin.weight.grad.abs().sum() > 0
    assert args[1].grad.abs().sum() > 0
