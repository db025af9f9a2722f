"""Head dim 256 in the port's forward kernels (K1 and K2) against the JAX
package on the CPU:

* the plain K1 bodies at D = 256 (the rope and the qk norm inside, the
  pipelined body without rope, the masked exact body with rope through the
  pad route) against JAX's ``flash_attention`` and its dispatcher, the
  Pallas kernel in interpret mode;
* the plain K2 at D = 256 against ``_flash_forward_chunked`` in interpret
  mode;
* the route (``attention.route`` on meta tensors): D = 256 takes the
  kernel, and the pad route admits 256, under autograd too (every
  instance, K1 and K2 with the lse, K3 and K4, takes 64, 128 and 256);
* a tiny FLUX of 2 heads x 256 (``axes_dims_rope=(32, 112, 112)``, 1 + 1
  blocks) carried across by the bridge, JAX on its kernel route in
  interpret mode, the port on its kernel wrappers (their plain versions
  here): in f32, in bf16, and with ``MAX_KV_SEQ`` lowered so that every
  attention is K2's wrapper.

On the CPU each wrapper runs its plain version; the CUDA kernels are
``tests/test_torch_kernels.py``'s ``cuda`` cases. Inputs from
``np.random.default_rng``. Tolerances: f32 1e-4 absolute and relative
(float32 sums in another order); bf16 attention within 1e-2 at the worst
element and 1e-3 on average (a bf16 step of outputs below 2, the bars of
the kernels' card tests), the bf16 DiT within 2e-2 relative L2 (bf16
roundings at the same points, a rounding flipped here and there by the
f32 sums' order, through two blocks).
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
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
from x2i_torch.ops import attention as tattn
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.params import load_flax

jattn = importlib.import_module("x2i_tpu.ops.attention")
TOL = dict(atol=1e-4, rtol=1e-4)
D = 256
AXES = (32, 112, 112)
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(
        np.array(a, np.float32)).to(dtype)


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        err = np.abs(got - want)
        assert err.max() <= 1e-2 and err.mean() <= 1e-3, (err.max(),
                                                          err.mean())


def _tables(s):
    """FLUX's half-layout rope tables at D = 256 for s joint tokens (the
    text's zeros, then a 16 x 16 grid), (S, 256) f32."""
    ids = np.concatenate([np.zeros((s - 64, 3), np.float32),
                          np.asarray(prepare_latent_image_ids(16, 16))])
    from x2i_tpu.ops.rope import flux_rope_freqs_half
    return tuple(np.asarray(x) for x in flux_rope_freqs_half(
        jnp.asarray(ids), AXES))


# ------------------------------------------------------------------- K1

# case -> (S, q heads, kv heads, rope, qk norm scales' shape, kv mask)
K1_CASES = {
    "rope, per-row qk norm (K1a)": (256, 2, 2, True, "row", False),
    "rope, shared qk norm (K1a)": (256, 2, 2, True, "shared", False),
    "no rope (K1c)": (256, 2, 2, False, None, False),
    "pad route, rope, per-row norm (K1b masked)": (200, 2, 2, True, "row",
                                                   True),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_plain_bodies_match_jax(case, dtype):
    """The port's plain K1 at D = 256 through its dispatcher (``"kernel"``:
    the wrappers, whose plain versions run on CPU tensors) against JAX's
    dispatcher on its Pallas route (``"pallas"``, interpret mode): the
    pipelined bodies with and without the in-kernel rope and qk norm at
    256 tokens, and at 200 tokens the pad route's masked exact body with
    the rope inside. Inputs (B, S, H, D), as the DiT passes them."""
    s, hq, hk, rope, norm, _ = K1_CASES[case]
    npd, jd, td = DTYPES[dtype]
    rng = np.random.default_rng(s + hq + len(case))
    q = rng.standard_normal((1, s, hq, D)).astype(npd)
    k, v = (rng.standard_normal((1, s, hk, D)).astype(npd)
            for _ in range(2))
    tabs = _tables(s) if rope else None
    scales = None
    if norm is not None:
        shape = (s, D) if norm == "row" else (D,)
        scales = [(1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
                  for _ in range(2)]
    jkw, tkw = {}, {}
    if tabs is not None:
        jkw["rope"] = tuple(jnp.asarray(x) for x in tabs)
        tkw["rope"] = tuple(t(x) for x in tabs)
    if scales is not None:
        jkw["qk_norm"] = (*(jnp.asarray(w) for w in scales), 1e-6)
        tkw["qk_norm"] = (*(t(w) for w in scales), 1e-6)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda q, k, v: jattn.attention(
            q, k, v, implementation="pallas", **jkw))(
                *(jnp.asarray(x, jd) for x in (q, k, v)))
    assert tattn.route(*(torch.empty(x.shape, dtype=td, device="meta")
                         for x in (q, k))) == ("kernel" if s % 128 == 0
                                               else "pad")
    with torch.no_grad():
        got = tattn.attention(*(t(x, td) for x in (q, k, v)),
                              implementation="kernel", **tkw)
    assert got.dtype == td
    _close(n(got), n(want), dtype)


# ------------------------------------------------------------------- K2

# case -> (Sq, Skv, q heads, kv heads, kv mask, causal)
K2_CASES = {
    "plain": (256, 256, 2, 2, False, False),
    "mask, causal, GQA 4:2": (256, 384, 4, 2, True, True),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_plain_matches_jax(case):
    """``flash_forward_chunked`` on CPU tensors (K2's plain version) at
    D = 256 against ``_flash_forward_chunked`` in interpret mode with 128 x
    128 tiles, bf16, on the rows that have a valid key."""
    sq, skv, hq, hk, masked, causal = K2_CASES[case]
    rng = np.random.default_rng(sq + skv)
    bf = ml_dtypes.bfloat16
    q = rng.standard_normal((2, hq, sq, D)).astype(bf)
    k, v = (rng.standard_normal((2, hk, skv, D)).astype(bf)
            for _ in range(2))
    mask = None
    rows = np.ones((2, 1, sq, 1), bool)
    if masked:
        cols = np.arange(skv)[None]
        mask = cols < np.array([[skv - 37], [70]])
        rows = mask.any(-1)[:, None, None, None]
    scale = 1.0 / 16.0
    with pltpu.force_tpu_interpret_mode():
        want = jfa._flash_forward_chunked(
            *(jnp.asarray(x) for x in (q, k, v)),
            None if mask is None else jnp.asarray(mask), causal=causal,
            scale=scale, block_q=128, block_k=128)
    with torch.no_grad():
        got = tfa.flash_forward_chunked(
            *(t(x, torch.bfloat16) for x in (q, k, v)),
            None if mask is None else torch.as_tensor(mask), causal, scale)
    assert got.dtype == torch.bfloat16
    _close(n(got) * rows, n(want) * rows, "bf16")


# ---------------------------------------------------------------- route

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_at_d256(dtype):
    """Meta tensors that require grad (a call autograd records): D = 256
    takes the kernel (the DiT's 4608 and 16,896 tokens) or the pad route
    (4112 tokens, as JAX's ``pad_path`` admits 256), as D = 128 does and
    as the forward does; ``supported`` says so, and the shape checks of
    the lse wrappers and of K3 and K4 (``check_kernel_shapes``) and of K2
    (``check_shapes``) take the shapes without a raise."""
    def meta(s, d):
        return torch.empty((1, s, 12, d), dtype=dtype, device="meta",
                           requires_grad=True)

    for s, want in ((4608, "kernel"), (16896, "kernel"), (4112, "pad")):
        assert tattn.route(meta(s, D), meta(s, D)) == want
        assert tattn.route(meta(s, 128), meta(s, 128)) == want
    assert tattn.route(meta(4608, D), meta(4608, D),
                       implementation="kernel") == "kernel"
    assert tfa.supported((1, 12, 4608, D), 4608)
    assert tfa.HEAD_DIMS == (64, 128, 256)
    for s in (4608, 16896):
        shape = (1, 12, s, D)
        assert tfa.check_kernel_shapes(shape, shape, shape, [shape]
                                       )[-1] == D
        assert tfa.check_shapes(shape, shape, shape)[-1] == D


@pytest.mark.parametrize("requires_grad", [False, True])
def test_dispatcher_tells_the_route_whether_autograd_records(
        requires_grad, monkeypatch):
    """``attention`` on the kernel route at D = 256 takes the flash
    kernels' autograd ``Function`` when the call is recorded (an input that
    requires grad under grad mode) and not under ``no_grad``; the route
    itself reads no autograd state."""
    seen = []
    apply = tfa._FlashAttention.apply

    def spy(*args):
        seen.append(args[0].shape)
        return apply(*args)

    monkeypatch.setattr(tfa._FlashAttention, "apply", spy)
    q = torch.zeros((1, 128, 2, D), requires_grad=requires_grad)
    out = tattn.attention(q, q, q, implementation="kernel")
    with torch.no_grad():
        tattn.attention(q, q, q, implementation="kernel")
    assert seen == ([(1, 2, 128, D)] if requires_grad else [])
    assert (out.grad_fn is not None) == requires_grad


# --------------------------------------------------------- the DiT, tiny

FLUX_KW = dict(attention_head_dim=D, num_attention_heads=2,
               axes_dims_rope=AXES, num_layers=1, num_single_layers=1)
S_IMG, S_TXT = 196, 60             # a 14 x 14 grid: 256 joint tokens


def _spy(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(tfa, name)

        def counted(*a, _f=fn, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)
    return calls


@pytest.mark.parametrize("case", ["f32", "bf16", "f32 fused glue",
                                  "f32 above MAX_KV_SEQ"])
def test_tiny_dit_matches_jax(case, monkeypatch):
    """One DiT call of a 2 x 256 FLUX (1 + 1 blocks, 196 image + 60 text
    tokens) on the same weights: JAX on its kernel route in interpret mode
    (flash attention with the rope inside, and with the fused glue the qk
    norm too and ``ln_mod``), the port on its kernel wrappers. With
    ``MAX_KV_SEQ`` lowered to 128 in both packages every attention is K2's
    wrapper (the qk norm and the rope outside), spied on. The bridge's
    per-head q/k permutation into the half rope layout holds at 256."""
    dtype = "bf16" if case == "bf16" else "f32"
    npd, jd, td = DTYPES[dtype]
    fused = "fused" in case
    if "MAX_KV_SEQ" in case:
        for mod in (tfa, jfa):
            monkeypatch.setattr(mod, "MAX_KV_SEQ", 128)
    monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    jc = jcfg.tiny_flux_config(use_pallas_attention=True, fused_glue=fused,
                               dtype=jd, param_dtype=jd, **FLUX_KW)
    rng = np.random.default_rng(25)
    args = [rng.standard_normal((1, S_IMG, jc.in_channels)),
            rng.standard_normal((1, S_TXT, jc.joint_attention_dim)),
            rng.standard_normal((1, jc.pooled_projection_dim)),
            np.array([0.7]),
            np.asarray(prepare_latent_image_ids(28, 28)),
            np.zeros((S_TXT, 3))]
    args = [np.asarray(a, np.float32) for a in args]
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(npd),
                                  flux_tree(25, jc, S_IMG, S_TXT))
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(JFlux(jc).apply)(tree, *(jnp.asarray(a)
                                                for a in args))
    model = load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
        attention_impl="kernel", fused_glue=fused, dtype=td, **FLUX_KW)),
        tree)
    calls = _spy(monkeypatch, ["flash_attention_plain",
                               "flash_forward_chunked"])
    with torch.inference_mode():
        got = model(*(t(a) for a in args))
    blocks = jc.num_layers + jc.num_single_layers
    chunked = "MAX_KV_SEQ" in case
    assert calls == {"flash_attention_plain": 0 if chunked else blocks,
                     "flash_forward_chunked": blocks if chunked else 0}
    assert got.dtype == td
    if dtype == "f32":
        np.testing.assert_allclose(n(got), n(want), **TOL)
    else:
        rel = np.linalg.norm(n(got) - n(want)) / np.linalg.norm(n(want))
        assert rel <= 2e-2, rel
