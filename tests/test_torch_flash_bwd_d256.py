"""Head dim 256 under autograd: the port's K1 with the lse, K2 with the
lse, K3 and K4 at D = 256 against the JAX package on the CPU, in float32,
the Pallas kernels in interpret mode:

* ``flash_forward_lse`` and ``flash_backward_plain`` against
  ``_flash_forward(return_lse=True)`` and ``_flash_backward``: no mask, kv
  mask + causal + GQA 4:2, the rope inside the kernels, the rope with a
  mask and the causal mask;
* ``flash_forward_chunked(return_lse=True)`` against
  ``_flash_forward_chunked`` with 128 x 128 tiles, on the rows that have a
  valid key;
* ``torch.autograd`` through ``flash_attention`` against ``jax.grad`` of
  JAX's ``flash_attention``;
* the input gradient of a tiny FLUX of 2 heads x 256 (1 + 1 blocks, the
  trainers' config: the rope outside the kernels, no fused glue) under
  ``attention_impl="kernel"``, against ``jax.grad`` of JAX's on its kernel
  route, on the same weights.

On the CPU each wrapper runs its plain version; the CUDA kernels are
``tests/test_torch_kernels.py``'s ``cuda`` cases. Inputs from
``np.random.default_rng``. Tolerance: atol and rtol 1e-4 (float32 sums in
another order; the lse in log2 units).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import flux_tree, one_thread  # noqa: F401
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion.sampling import prepare_latent_image_ids
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.ops import flash_attention as jfa
from x2i_torch.core import config as tcfg
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.params import load_flax

jattn = importlib.import_module("x2i_tpu.ops.attention")
TOL = dict(atol=1e-4, rtol=1e-4)
D = 256

# (label, B, Hq, Hk, S, kv mask, causal, rope)
CASES = [
    ("plain", 1, 2, 2, 128, False, False, False),
    ("mask-causal-gqa", 2, 4, 2, 128, True, True, False),
    ("rope", 1, 2, 2, 128, False, False, True),
    ("rope-mask-causal", 2, 2, 2, 128, True, True, True),
]


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def n(x):
    return x.detach().float().numpy()


def _case(b, hq, hk, s, masked, rope, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, hq, s, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, hk, s, D)).astype(np.float32)
            for _ in range(2))
    mask = None
    if masked:
        mask = np.ones((b, s), bool)
        mask[:, s - 37:] = False
        mask[-1, 0] = False              # a row whose first key is masked
    tables = None
    if rope:
        ang = rng.uniform(0, 6.3, (s, D // 2)).astype(np.float32)
        tables = (np.concatenate([np.cos(ang)] * 2, -1),
                  np.concatenate([np.sin(ang)] * 2, -1))
    return q, k, v, do, mask, tables


def _jrope(tables):
    if tables is None:
        return None
    cos, sin = (jnp.asarray(x) for x in tables)
    return cos, jfa._rope_signed_sin(sin)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_lse_and_backward_match_jax(case):
    """K1 with the lse and K3 / K4's plain versions at D = 256 against the
    Pallas forward with its lse and backward, the backward on JAX's own
    residuals, so that it is held alone."""
    _, b, hq, hk, s, masked, causal, rope = case
    q, k, v, do, mask, tables = _case(b, hq, hk, s, masked, rope)
    scale = 1.0 / np.sqrt(D)
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jax.jit(lambda q, k, v: jfa._flash_forward(
            q, k, v, jmask, causal=causal, scale=scale, return_lse=True,
            rope=_jrope(tables)))(jq, jk, jv)
        jgrads = jax.jit(lambda q, k, v, o, lse, do: jfa._flash_backward(
            q, k, v, jmask, o, lse, do, causal=causal, scale=scale,
            rope=_jrope(tables)))(jq, jk, jv, jo, jlse, jdo)
    trope = None if tables is None else tuple(t(x) for x in tables)
    o, lse = tfa.flash_forward_lse(t(q), t(k), t(v), t(mask), causal, scale,
                                   trope)
    np.testing.assert_allclose(n(o), np.asarray(jo), **TOL)
    np.testing.assert_allclose(n(lse), np.asarray(jlse), **TOL)
    grads = tfa.flash_backward_plain(
        t(q), t(k), t(v), t(mask), t(np.asarray(jo)), t(np.asarray(jlse)),
        t(do), causal, scale, trope)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


# case -> (Sq, Skv, q heads, kv heads, kv mask, causal)
CHUNKED_CASES = {
    "plain": (256, 256, 2, 2, False, False),
    "mask, causal, GQA 4:2": (256, 384, 4, 2, True, True),
}


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_lse_matches_jax(case):
    """K2 with the lse at D = 256 (its plain version) against
    ``_flash_forward_chunked(return_lse=True)`` with 128 x 128 tiles, on
    the rows that have a valid key: o and the lse."""
    sq, skv, hq, hk, masked, causal = CHUNKED_CASES[case]
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, hq, sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, hk, skv, D)).astype(np.float32)
            for _ in range(2))
    mask = None
    rows = np.ones((2, 1, sq), bool)
    if masked:
        mask = np.arange(skv)[None] < np.array([[skv - 37], [70]])
        rows = mask.any(-1)[:, None, None]
    scale = 1.0 / 16.0
    with pltpu.force_tpu_interpret_mode():
        jo, jlse = jax.jit(lambda q, k, v: jfa._flash_forward_chunked(
            q, k, v, None if mask is None else jnp.asarray(mask),
            causal=causal, scale=scale, block_q=128, block_k=128,
            return_lse=True))(*(jnp.asarray(x) for x in (q, k, v)))
    with torch.no_grad():
        o, lse = tfa.flash_forward_chunked(
            t(q), t(k), t(v), t(mask), causal, scale, return_lse=True)
    np.testing.assert_allclose(n(o) * rows[..., None],
                               np.asarray(jo) * rows[..., None], **TOL)
    np.testing.assert_allclose(n(lse) * rows, np.asarray(jlse) * rows,
                               **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_autograd_matches_jax_grad(case, monkeypatch):
    """torch.autograd through ``flash_attention`` at D = 256 (the
    Function's CPU route: the plain K1-lse, K3 and K4, each wrapper called
    once) against jax.grad through JAX's custom_vjp, the Pallas kernels in
    interpret mode."""
    _, b, hq, hk, s, masked, causal, rope = case
    q, k, v, do, mask, tables = _case(b, hq, hk, s, masked, rope, seed=1)
    jmask = None if mask is None else jnp.asarray(mask)
    jtab = None if tables is None else tuple(jnp.asarray(x) for x in tables)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, kv_mask=jmask, causal=causal,
                                rope=jtab)
        return jnp.sum(o * jnp.asarray(do))

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    calls = []
    for name in ("flash_forward_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    args = [t(x).requires_grad_() for x in (q, k, v)]
    trope = None if tables is None else tuple(t(x) for x in tables)
    o = tfa.flash_attention(*args, kv_mask=t(mask), causal=causal,
                            rope=trope)
    (o * t(do)).sum().backward()
    assert calls == ["flash_forward_lse", "flash_bwd_dq", "flash_bwd_dkv"]
    for got, w in zip(args, want):
        np.testing.assert_allclose(n(got.grad), np.asarray(w), **TOL)


# --------------------------------------------------------- the DiT, tiny

FLUX_KW = dict(attention_head_dim=D, num_attention_heads=2,
               axes_dims_rope=(32, 112, 112), num_layers=1,
               num_single_layers=1, rope_in_kernel=False, fused_glue=False)
S_IMG, S_TXT = 196, 60             # a 14 x 14 grid: 256 joint tokens


def test_tiny_dit_gradient_matches_jax(monkeypatch):
    """The gradient of sum(out * cotangent) of a 2 x 256 FLUX (1 + 1
    blocks, 196 image + 60 text tokens, the trainers' config: the qk norm
    and the rope outside the kernels, no fused glue), f32, with respect to
    the image and the text tokens: the port on its kernel wrappers (K1 with
    the lse, K3 and K4 once a block) against ``jax.grad`` of JAX's FLUX on
    its kernel route in interpret mode, on the same weights."""
    monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    jc = jcfg.tiny_flux_config(use_pallas_attention=True, **FLUX_KW)
    rng = np.random.default_rng(26)
    x = rng.standard_normal((1, S_IMG, jc.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((1, S_TXT, jc.joint_attention_dim)
                              ).astype(np.float32)
    rest = [rng.standard_normal((1, jc.pooled_projection_dim)),
            np.array([0.7]), np.asarray(prepare_latent_image_ids(28, 28)),
            np.zeros((S_TXT, 3))]
    rest = [np.asarray(a, np.float32) for a in rest]
    cot = rng.standard_normal((1, S_IMG, jc.in_channels)).astype(np.float32)
    tree = flux_tree(26, jc, S_IMG, S_TXT)
    jflux = JFlux(jc)

    def loss(x, ctx):
        out = jflux.apply(tree, x, ctx, *(jnp.asarray(a) for a in rest))
        return jnp.sum(out * jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                       jnp.asarray(ctx))
    model = load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
        attention_impl="kernel", **FLUX_KW)), tree)
    calls = {name: 0 for name in ("flash_forward_lse", "flash_bwd_dq",
                                  "flash_bwd_dkv", "xla_attention")}
    for name in calls:
        fn = getattr(tfa, name)

        def counted(*a, _f=fn, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)
    args = [t(a).requires_grad_() for a in (x, ctx)]
    out = model(*args, *(t(a) for a in rest))
    (out * t(cot)).sum().backward()
    blocks = jc.num_layers + jc.num_single_layers
    assert calls == {"flash_forward_lse": blocks, "flash_bwd_dq": blocks,
                     "flash_bwd_dkv": blocks, "xla_attention": 0}
    for got, w in zip(args, want):
        np.testing.assert_allclose(n(got.grad), np.asarray(w), **TOL)
