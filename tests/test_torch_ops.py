"""The port's ops (x2i_torch/ops) against the JAX package's, on the CPU.

Inputs come from np.random.default_rng(seed) and go through both packages
as numpy arrays. Where the JAX function reaches a Pallas kernel it runs in
TPU interpret mode, as the JAX package's own tests run it. Tolerances:
float32 cases agree to 2e-5 (summation order only); bf16 cases to one bf16
step, with the rounding points pinned separately.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import one_thread  # noqa: F401 (autouse)

from x2i_tpu.diffusion.sampling import prepare_latent_image_ids
from x2i_tpu.ops import flash_attention as jfa
from x2i_tpu.ops import fused_glue as jfg
from x2i_tpu.ops import norms as jnorms
from x2i_tpu.ops import rope as jrope
from x2i_torch.ops import attention as tattn
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.ops import fused_glue as tfg
from x2i_torch.ops import norms as tnorms
from x2i_torch.ops import rope as trope

# the package's __init__ re-exports the function under the module's name
jattn = importlib.import_module("x2i_tpu.ops.attention")

F32 = dict(atol=2e-5, rtol=2e-5)
# float32 products and convolutions in full float32 on a card too (TF32
# off, as the port's entry points set it; the CPU ignores both flags)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def n(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _joint_ids(s_txt, grid):
    return np.concatenate([np.zeros((s_txt, 3), np.float32),
                           np.asarray(prepare_latent_image_ids(grid, grid))])


def _tables(s, d):
    """FLUX half-layout tables for s joint tokens (s - 64 txt, 64 img)."""
    axes = (16, 24, 24) if d == 64 else (16, 56, 56)
    ids = _joint_ids(s - 64, 16)
    cos, sin = jrope.flux_rope_freqs_half(jnp.asarray(ids), axes)
    return np.asarray(cos), np.asarray(sin)


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)) * 3 + 1
    w, b = 1 + 0.1 * rng.standard_normal(48), rng.standard_normal(48)
    np.testing.assert_allclose(n(tnorms.rms_norm(t(x), t(w))),
                               n(jnorms.rms_norm(j(x), j(w))), **F32)
    np.testing.assert_allclose(n(tnorms.layer_norm(t(x))),
                               n(jnorms.layer_norm(j(x))), **F32)
    np.testing.assert_allclose(n(tnorms.layer_norm(t(x), t(w), t(b), 1e-5)),
                               n(jnorms.layer_norm(j(x), j(w), j(b), 1e-5)),
                               **F32)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    ids = _joint_ids(8, 8)
    for got, want in zip(trope.flux_rope_freqs_half(t(ids), (8, 12, 12)),
                         jrope.flux_rope_freqs_half(j(ids), (8, 12, 12))):
        np.testing.assert_allclose(n(got), n(want), atol=1e-6)
    pos = np.clip(np.cumsum(rng.random((2, 24)) > 0.3, -1) - 1, 0, None)
    tc, ts = trope.rope_freqs_half(torch.as_tensor(pos), 16, 1e6)
    jc, js = jrope.rope_freqs_half(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(n(tc), n(jc), atol=1e-6)
    np.testing.assert_allclose(n(ts), n(js), atol=1e-6)
    x = rng.standard_normal((2, 24, 3, 16))
    np.testing.assert_allclose(n(trope.apply_rope_half(t(x), tc, ts)),
                               n(jrope.apply_rope_half(j(x), jc, js)),
                               **F32)
    np.testing.assert_array_equal(trope.half_layout_perm(32),
                                  jrope.half_layout_perm(32))


def _qkv(rng, b, hq, hk, s, d):
    return (rng.standard_normal((b, hq, s, d)),
            rng.standard_normal((b, hk, s, d)),
            rng.standard_normal((b, hk, s, d)))


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("per_row", [True, False])
def test_flash_rope_plain_matches_interpret(s, d, per_row):
    """K1a's plain version == the TPU kernel (in-kernel qk RMSNorm and
    rope; S=128 takes the one-pass body, S=256 the pipelined one)."""
    rng = np.random.default_rng(s + d + per_row)
    q, k, v = _qkv(rng, 1, 2, 2, s, d)
    cos, sin = _tables(s, d)
    shape = (s, d) if per_row else (d,)
    # per-row tables are stored in bf16 by the kernel: use bf16 values
    qw, kw = (np.asarray(j(1 + 0.1 * rng.standard_normal(shape),
                           jnp.bfloat16), np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention(j(q), j(k), j(v), rope=(j(cos), j(sin)),
                                   qk_norm=(j(qw), j(kw), 1e-6))
    got = tfa.flash_attention_plain(t(q), t(k), t(v), rope=(t(cos), t(sin)),
                                    qk_norm=(t(qw), t(kw), 1e-6))
    np.testing.assert_allclose(n(got), n(want), **F32)


def test_flash_rope_plain_bf16_rounding_points():
    """In bf16 the plain version rounds where the TPU kernel does (q after
    norm/rope/scale, rotated k, p before PV): it sits much closer to the
    kernel than the same math without those roundings."""
    rng = np.random.default_rng(7)
    s, d = 256, 128
    q, k, v = (np.asarray(j(a, jnp.bfloat16), np.float32)
               for a in _qkv(rng, 1, 2, 2, s, d))
    cos, sin = _tables(s, d)
    qw, kw = (np.asarray(j(1 + 0.1 * rng.standard_normal(d), jnp.bfloat16),
                         np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = n(jfa.flash_attention(
            j(q, jnp.bfloat16), j(k, jnp.bfloat16), j(v, jnp.bfloat16),
            rope=(j(cos), j(sin)), qk_norm=(j(qw), j(kw), 1e-6)))
    bf = torch.bfloat16
    got = n(tfa.flash_attention_plain(t(q, bf), t(k, bf), t(v, bf),
                                      rope=(t(cos), t(sin)),
                                      qk_norm=(t(qw), t(kw), 1e-6)))
    exact = n(tfa.flash_attention_plain(t(q), t(k), t(v),
                                        rope=(t(cos), t(sin)),
                                        qk_norm=(t(qw), t(kw), 1e-6)))
    err = np.abs(got - want)
    assert err.max() <= 2 ** -8 * np.abs(want).max() + 1e-6, err.max()
    assert err.mean() * 4 < np.abs(exact - want).mean()


@pytest.mark.parametrize("case", ["mask", "causal", "mask+causal",
                                  "row0-masked"])
def test_flash_exact_plain_matches_interpret(case):
    """K1b's plain version == the TPU kernel's one-pass body: GQA 4/2,
    kv mask, causal; a row with every key masked gives the mean of V."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 4, 2, 128, 64)
    mask = np.ones((2, 128), bool)
    mask[0, 90:] = False
    mask[1, 40:] = False
    if case == "row0-masked":
        mask[:, 0] = False
    kw = dict(causal="causal" in case or case == "row0-masked")
    if case != "causal":
        kw["kv_mask"] = mask
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention(j(q), j(k), j(v), **{
            a: (jnp.asarray(b) if a == "kv_mask" else b)
            for a, b in kw.items()})
    got = tfa.flash_attention_plain(t(q), t(k), t(v), **{
        a: (torch.as_tensor(b) if a == "kv_mask" else b)
        for a, b in kw.items()})
    np.testing.assert_allclose(n(got), n(want), **F32)
    if case == "row0-masked":
        mean_v = np.repeat(v.mean(axis=2), 2, axis=1)      # GQA group 2
        np.testing.assert_allclose(n(got)[:, :, 0], mean_v, **F32)


def test_xla_attention_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 4, 2, 24, 16)
    mask = np.arange(24)[None] < np.array([[20], [9]])
    want = jfa.xla_attention(j(q), j(k), j(v), kv_mask=jnp.asarray(mask),
                             causal=True)
    got = tfa.xla_attention(t(q), t(k), t(v), kv_mask=torch.as_tensor(mask),
                            causal=True)
    np.testing.assert_allclose(n(got), n(want), **F32)


@pytest.mark.parametrize("s", [100, 128])
def test_dispatcher_matches_jax_kernel_route(s, monkeypatch):
    """attention(implementation="kernel") == the JAX dispatcher's Pallas
    route: S=100 takes the pad-and-mask path (pad to 128, masked keys),
    S=128 the kernel directly; rope and per-row qk norm ride along."""
    rng = np.random.default_rng(s)
    d, h = 64, 2
    q, k, v = (rng.standard_normal((1, s, h, d)) for _ in range(3))
    ids = np.concatenate([np.zeros((s - 64, 3), np.float32),
                          np.asarray(prepare_latent_image_ids(16, 16))])
    cos, sin = (np.asarray(a) for a in
                jrope.flux_rope_freqs_half(jnp.asarray(ids), (16, 24, 24)))
    qw, kw = (np.asarray(j(1 + 0.1 * rng.standard_normal((s, d)),
                           jnp.bfloat16), np.float32) for _ in range(2))
    monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = jattn.attention(j(q), j(k), j(v), implementation="pallas",
                               rope=(j(cos), j(sin)),
                               qk_norm=(j(qw), j(kw), 1e-6))
    got = tattn.attention(t(q), t(k), t(v), implementation="kernel",
                          rope=(t(cos), t(sin)),
                          qk_norm=(t(qw), t(kw), 1e-6))
    np.testing.assert_allclose(n(got), n(want), **F32)
    plain = tattn.attention(t(q), t(k), t(v), implementation="plain",
                            rope=(t(cos), t(sin)),
                            qk_norm=(t(qw), t(kw), 1e-6))
    np.testing.assert_allclose(n(plain), n(want), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_mod_plain_matches_interpret(dtype):
    """K5's plain version == the TPU kernel: f32 to 2e-5, bf16 within one
    bf16 step (rtol 8e-3 of the largest intermediate)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 96, 192)) * 2 + 0.5
    shift, scale = (0.5 * rng.standard_normal((2, 192)) for _ in range(2))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = n(jfg.ln_mod(j(x, jd), j(shift, jd), j(scale, jd), block_rows=64,
                        interpret=True))
    got = n(tfg.ln_mod_plain(t(x, td), t(shift, td), t(scale, td)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        tol = 8e-3 * (np.abs(want) + np.abs(n(t(shift, td)))[:, None] + 1)
        assert (np.abs(got - want) <= tol).all()


def test_cpu_wrappers_take_the_plain_path():
    """On CPU tensors the kernel wrappers run their plain versions: no
    build, no launch counted."""
    rng = np.random.default_rng(9)
    q, k, v = (t(a) for a in _qkv(rng, 1, 2, 1, 128, 64))
    mask = torch.arange(128)[None] < 100
    before = dict(tfa.KERNEL.launches)
    np.testing.assert_array_equal(
        n(tfa.flash_attention(q, k, v, kv_mask=mask, causal=True)),
        n(tfa.flash_attention_plain(q, k, v, kv_mask=mask, causal=True)))
    x = t(rng.standard_normal((1, 8, 64)))
    e = t(rng.standard_normal((1, 64)))
    np.testing.assert_array_equal(n(tfg.ln_mod(x, e, e)),
                                  n(tfg.ln_mod_plain(x, e, e)))
    assert tfa.KERNEL.launches == before
    assert tfa.KERNEL._lib is None
    assert tfg.ROW_GLUE._lib is None
