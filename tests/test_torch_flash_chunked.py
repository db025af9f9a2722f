"""K2, the chunked online-softmax forward, and the routing above
``MAX_KV_SEQ``, against the JAX package on the CPU.

Inputs come from np.random.default_rng(seed), float32, and go through both
packages as numpy arrays; the JAX side runs its Pallas kernel in TPU
interpret mode. Tolerances: o to 2e-5 and the base-2 lse to 1e-5 against
``_flash_forward_chunked`` with the same tile sizes (the same sums in the
same order); value and gradient of ``flash_attention`` to 1e-4 (the norm,
the rope and the plain-attention recompute of the backward sum in other
orders). Rows with no valid key are compared with nothing: there the result
depends on the tile sizes in JAX itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import one_thread  # noqa: F401 (autouse)

from x2i_tpu.diffusion.sampling import prepare_latent_image_ids
from x2i_tpu.ops import flash_attention as jfa
from x2i_tpu.ops import rope as jrope
from x2i_torch.ops import flash_attention as tfa


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _valid_rows(mask, causal, sq):
    """(B, Sq) bool: the rows with at least one valid key."""
    if not causal:
        return np.broadcast_to(mask.any(-1, keepdims=True),
                               (mask.shape[0], sq))
    seen = np.cumsum(mask, -1) > 0
    if sq <= mask.shape[1]:
        return seen[:, :sq]
    return np.concatenate(
        [seen, np.repeat(seen[:, -1:], sq - mask.shape[1], 1)], 1)


CASES = {
    # name: (Sq, Skv, causal, mask)
    "plain": (256, 256, False, None),
    "causal": (256, 256, True, None),
    "kv-mask": (256, 256, False, "right"),
    "causal-mask-gqa": (256, 256, True, "right+left"),
    "sq<skv": (128, 256, True, "right"),
    "sq>skv": (256, 128, True, None),
}


def _case(name, seed=0):
    sq, skv, causal, kind = CASES[name]
    rng = np.random.default_rng(seed)
    b = 2
    q = rng.standard_normal((b, 4, sq, 64))
    k, v = (rng.standard_normal((b, 2, skv, 64)) for _ in range(2))
    mask = None
    if kind is not None:
        cols = np.arange(skv)[None]
        mask = cols < np.array([[skv - 37], [70]])
        if kind == "right+left":            # batch 1 left-padded
            mask[1] = cols[0] >= 150
    return q, k, v, mask, causal


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_plain_matches_interpret(name):
    """``flash_forward_chunked_plain`` == ``_flash_forward_chunked`` in
    Pallas interpret mode with 128 x 128 tiles: GQA 4 / 2 heads, kv mask,
    causal mask with the block skip, Sq != Skv; valid rows only."""
    q, k, v, mask, causal = _case(name)
    scale = 1.0 / 8.0
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jfa._flash_forward_chunked(
            j(q), j(k), j(v), None if mask is None else jnp.asarray(mask),
            causal=causal, scale=scale, block_q=128, block_k=128,
            return_lse=True)
    tm = None if mask is None else torch.as_tensor(mask)
    got_o, got_lse = tfa.flash_forward_chunked_plain(
        t(q), t(k), t(v), tm, causal, scale, return_lse=True, block_q=128,
        block_k=128)
    rows = _valid_rows(np.ones((2, k.shape[2]), bool) if mask is None
                       else mask, causal, q.shape[2])[:, None, :]
    assert rows.any() and (mask is None or name == "kv-mask"
                           or name == "sq<skv" or not rows.all())
    np.testing.assert_allclose(n(got_o) * rows[..., None],
                               n(want_o) * rows[..., None], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(np.where(rows, n(got_lse), 0),
                               np.where(rows, n(want_lse), 0), atol=1e-5,
                               rtol=1e-6)
    # the block skip changes nothing on a row that has a valid key, and
    # neither do the default 256 x 512 tiles beyond summation order
    no_skip = tfa.flash_forward_chunked_plain(
        t(q), t(k), t(v), tm, causal, scale, block_q=128, block_k=128,
        causal_skip=False)
    np.testing.assert_array_equal(n(no_skip) * rows[..., None],
                                  n(got_o) * rows[..., None])
    wide = tfa.flash_forward_chunked(t(q), t(k), t(v), tm, causal, scale)
    np.testing.assert_allclose(n(wide) * rows[..., None],
                               n(got_o) * rows[..., None], atol=2e-5)
    ref = tfa.xla_attention(t(q), t(k), t(v), tm, causal, scale)
    np.testing.assert_allclose(n(got_o) * rows[..., None],
                               n(ref) * rows[..., None], atol=2e-5)


def _tables(s, d):
    axes = (16, 24, 24) if d == 64 else (16, 56, 56)
    ids = np.concatenate([np.zeros((s - 64, 3), np.float32),
                          np.asarray(prepare_latent_image_ids(16, 16))])
    cos, sin = jrope.flux_rope_freqs_half(jnp.asarray(ids), axes)
    return np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize("norm", ["none", "shared", "per-row"])
def test_routing_above_max_kv_seq_matches_jax(norm, monkeypatch):
    """``flash_attention`` at 256 tokens with MAX_KV_SEQ lowered to 128 in
    both packages: the RMSNorm, then the rope, outside the kernel, K2
    forward, the backward through the plain attention; value and gradient
    (q, k, v) against JAX in interpret mode."""
    monkeypatch.setattr(jfa, "MAX_KV_SEQ", 128)
    monkeypatch.setattr(tfa, "MAX_KV_SEQ", 128)
    rng = np.random.default_rng(3)
    s, d = 256, 64
    q, k, v = (rng.standard_normal((1, 2, s, d)) for _ in range(3))
    w = rng.standard_normal((1, 2, s, d))
    cos, sin = _tables(s, d)
    shape = {"shared": (d,), "per-row": (s, d)}.get(norm)
    scales = None if shape is None else tuple(
        1 + 0.1 * rng.standard_normal(shape) for _ in range(2))

    def jloss(q, k, v):
        qk_norm = None if scales is None else (j(scales[0]), j(scales[1]),
                                               1e-6)
        o = jfa.flash_attention(q, k, v, rope=(j(cos), j(sin)),
                                qk_norm=qk_norm)
        return (o * j(w)).sum(), o

    with pltpu.force_tpu_interpret_mode():
        (_, want), want_g = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(j(q), j(k), j(v))

    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    qk_norm = None if scales is None else (t(scales[0]), t(scales[1]), 1e-6)
    before = dict(tfa.KERNEL_CHUNKED.launches)
    got = tfa.flash_attention(tq, tk, tv, rope=(t(cos), t(sin)),
                              qk_norm=qk_norm)
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)
    for g, wg in zip((tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(n(g), n(wg), atol=1e-4)
    # without autograd the same route, the same numbers
    with torch.no_grad():
        again = tfa.flash_attention(tq, tk, tv, rope=(t(cos), t(sin)),
                                    qk_norm=qk_norm)
    np.testing.assert_array_equal(n(again), n(got))
    assert tfa.KERNEL_CHUNKED.launches == before      # CPU: the plain version
    assert tfa.KERNEL_CHUNKED._lib is None


def test_routing_keeps_k1_up_to_max_kv_seq(monkeypatch):
    """At or below MAX_KV_SEQ the call is K1's (norm and rope inside, one
    rounding); above it K2's chain. In bf16 the two differ by roundings,
    and each sits on its own plain version."""
    rng = np.random.default_rng(5)
    s, d = 256, 64
    bf = torch.bfloat16
    q, k, v = (t(rng.standard_normal((1, 2, s, d))).to(bf) for _ in range(3))
    cos, sin = (t(a) for a in _tables(s, d))
    scales = (t(1 + 0.1 * rng.standard_normal(d)),
              t(1 + 0.1 * rng.standard_normal(d)), 1e-6)
    k1 = tfa.flash_attention(q, k, v, rope=(cos, sin), qk_norm=scales)
    np.testing.assert_array_equal(
        n(k1), n(tfa.flash_attention_plain(q, k, v, rope=(cos, sin),
                                           qk_norm=scales)))
    monkeypatch.setattr(tfa, "MAX_KV_SEQ", 128)
    k2 = tfa.flash_attention(q, k, v, rope=(cos, sin), qk_norm=scales)
    qn, kn = (tfa.rope_bhsd(tfa.rms_norm(x, w, 1e-6), cos, sin)
              for x, w in ((q, scales[0]), (k, scales[1])))
    assert qn.dtype == bf
    np.testing.assert_array_equal(
        n(k2), n(tfa.flash_forward_chunked_plain(qn, kn, v)))
    assert not np.array_equal(n(k1), n(k2))
    np.testing.assert_allclose(n(k1), n(k2), atol=3e-2)
    with pytest.raises(ValueError, match="rope"):
        tfa.flash_attention(q, k, v, qk_norm=scales)


def test_chunked_wrapper_is_forward_only():
    q, k, v = (torch.zeros((1, 1, 128, 64), requires_grad=True)
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_forward_chunked(q, k, v)
