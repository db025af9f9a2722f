"""The f32 instances of the flash kernels (K1 with the lse, K2, K3, K4) as
the port routes them, against the JAX package on the CPU, in float32:

* the dispatcher's route for f32 (``attention.route`` on meta tensors:
  the kernel or pad route under autograd and above ``MAX_KV_SEQ``, as
  JAX's ``supported`` rule gives them; f16 keeps the plain route);
* the f32 wrappers' argument checks (``instance_dtype``, ``check_rows``
  with f32 strides, ``f32_scratch_numel``), plain functions that run here
  without a card;
* ``flash_attention`` in f32 under autograd (``_FlashAttention``: the
  rope rotated outside, K1 with the lse or above ``MAX_KV_SEQ`` K2 with
  the lse, then K3 and K4 or the plain recompute), both limits lowered in
  both packages, against ``jax.grad`` of JAX's ``flash_attention`` with
  the Pallas kernels in interpret mode, on both sides of each limit;
* the slice as a whole at a small size: a tiny f32 FLUX carried across by
  the bridge, one DiT call above the lowered ``MAX_KV_SEQ`` (K2's route)
  and one phase-2 step (K1 with the lse, K3 and K4 on the pad route),
  against JAX's tiny FLUX through its plain reference (the XLA attention).

On the CPU each wrapper runs its plain version; the same calls on CUDA
tensors launch the f32 instances (``tests/test_torch_kernels.py``, marked
``cuda``). Inputs from ``np.random.default_rng``. Tolerance: atol and rtol
1e-4 (float32 sums in another order; the lse is in log2 units).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_lightcontrol import bank_tree, ctrl_cfgs
from test_torch_params import one_thread, random_tree
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion.sampling import prepare_latent_image_ids
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.models.vae import AutoencoderKL as JVAE
from x2i_tpu.ops import flash_attention as jfa
from x2i_tpu.train import lightcontrol as jlc
from x2i_torch.core import config as tcfg
from x2i_torch.models.controlnext import ControlBank
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.ops import attention as tattn
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.params import load_flax, load_flax_bank
from x2i_torch.train import harness as tharness

TOL = dict(atol=1e-4, rtol=1e-4)
F32, BF16 = torch.float32, torch.bfloat16


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def n(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ------------------------------------------------------------------ route

@pytest.mark.parametrize("tokens", [512, 257, 16896])
@pytest.mark.parametrize("dtype", [F32, BF16, torch.float16])
def test_route_takes_the_f32_instances_as_jax_supports_them(tokens, dtype):
    """Off the CPU (meta tensors) "auto" routes f32 as bf16, by JAX's
    ``supported`` rule and its pad route: 512 tokens to the kernel, 257
    padded, the 2048^2 DiT's 16896 tokens (above MAX_KV_SEQ: K2) to the
    kernel; the route reads no autograd state, so a call that records
    takes the same one (K1 with the lse, K3, K4). f16 takes the plain
    route; CPU tensors take it under "auto"; a bias or causal offset
    forces it, as in JAX."""
    q = torch.empty((1, tokens, 24, 128), dtype=dtype, device="meta")
    want = ("plain" if dtype == torch.float16 else
            "kernel" if tokens % 128 == 0 else "pad")
    assert tattn.route(q, q) == want
    assert tattn.route(torch.empty(q.shape, dtype=dtype), q) == "plain"
    assert tattn.route(q, q, bias=torch.empty(0)) == "plain"
    assert tattn.route(q, q, causal_offset=3) == "plain"
    assert tattn.route(q, q, implementation="kernel") == (
        "kernel" if tokens % 128 == 0 else "pad")


# ------------------------------------------------------------- arguments

@pytest.mark.parametrize("dtypes,want", [
    ((F32, F32, F32), F32), ((BF16, BF16, BF16, BF16), BF16),
    ((F32, BF16, F32), None), ((torch.float16,) * 3, None),
    ((F32, F32, F32, BF16), None)])
def test_instance_dtype(dtypes, want):
    """All inputs bf16 or all f32 pick an instance; mixed or f16 raise."""
    if want is None:
        with pytest.raises(ValueError, match="all torch.bfloat16"):
            tfa.instance_dtype(*dtypes)
    else:
        assert tfa.instance_dtype(*dtypes) == want


# (shape, strides, data_ptr, itemsize) -> legal: f32 rows need strides in
# multiples of 4 elements (16 bytes), bf16 rows 8
F32_ROWS = {
    "f32 strided view": ((1, 24, 16896, 128),
                         (24 * 16896 * 128, 128, 24 * 128, 1), 4096, 4,
                         True),
    "f32 row stride of 4": ((1, 2, 128, 4), (1024, 512, 4, 1), 16, 4, True),
    "f32 row stride of 6": ((1, 2, 128, 6), (1536, 768, 6, 1), 16, 4,
                            False),
    "bf16 row stride of 4": ((1, 2, 128, 4), (1024, 512, 4, 1), 16, 2,
                             False),
    "f32 start on 8 bytes": ((1, 2, 128, 64), (16384, 8192, 64, 1), 8, 4,
                             False),
    "f32 last dim strided": ((1, 2, 128, 64), (16384, 8192, 128, 2), 16, 4,
                             False),
}


@pytest.mark.parametrize("case", list(F32_ROWS))
def test_f32_row_layout(case):
    shape, strides, ptr, itemsize, legal = F32_ROWS[case]
    if legal:
        tfa.check_rows("q", shape, strides, ptr, itemsize=itemsize)
    else:
        with pytest.raises(ValueError, match="q"):
            tfa.check_rows("q", shape, strides, ptr, itemsize=itemsize)


@pytest.mark.parametrize("q,k,with_do,want", [
    # the 2048^2 DiT's K2: 3 x 24 x 16896 x 128 bf16 values, 311 MB
    ((1, 24, 16896, 128), (1, 24, 16896, 128), False, 3 * 24 * 16896 * 128),
    # the phase-2 step's K3 / K4: q, k, v and do
    ((1, 24, 4608, 128), (1, 24, 4608, 128), True, 4 * 24 * 4608 * 128),
    # GQA, Sq != Skv, batch 2
    ((2, 6, 256, 64), (2, 2, 640, 64), False, 2 * 64 * (6 * 256 + 4 * 640)),
    ((2, 6, 256, 64), (2, 2, 640, 64), True, 2 * 64 * (12 * 256 + 4 * 640)),
])
def test_f32_scratch_size(q, k, with_do, want):
    assert tfa.f32_scratch_numel(q, k, with_do) == want


# --------------------------------------------------- the autograd Function

def _tables(rng, s, d):
    ang = rng.uniform(0, 6.3, (s, d // 2)).astype(np.float32)
    return (np.concatenate([np.cos(ang)] * 2, -1),
            np.concatenate([np.sin(ang)] * 2, -1))


# (label, S, Hq, Hk, kv mask, causal, rope): with MAX_KV_SEQ 256 and
# ROPE_MAX_KV 128 in both packages, 128 tokens lie below both limits (JAX
# rotates inside its kernels), 256 between them (JAX rotates outside), 384
# above MAX_KV_SEQ (K2 with the lse, the plain recompute backward)
FUNCTION_CASES = [
    ("below both limits, rope", 128, 2, 2, False, False, True),
    ("between the limits, rope, mask, GQA", 256, 4, 2, True, False, True),
    ("above MAX_KV_SEQ, mask, causal, GQA", 384, 4, 2, True, True, False),
]


@pytest.mark.parametrize("case", FUNCTION_CASES,
                         ids=[c[0] for c in FUNCTION_CASES])
def test_function_matches_jax_grad(case, monkeypatch):
    """``flash_attention`` on f32 tensors that require grad: o, the lse of
    its forward kernel and (dq, dk, dv) by autograd, against JAX's
    ``flash_attention`` under ``jax.grad`` (jitted, the Pallas kernels in
    interpret mode) and its ``_fwd_impl(return_lse=True)``."""
    _, s, hq, hk, masked, causal, rope = case
    for mod in (tfa, jfa):
        monkeypatch.setattr(mod, "MAX_KV_SEQ", 256)
    monkeypatch.setattr(tfa, "ROPE_MAX_KV", 128)
    monkeypatch.setenv("X2I_FA_ROPE_MAX_KV", "128")
    rng = np.random.default_rng(s)
    d = 64
    q, do = (rng.standard_normal((1, hq, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, hk, s, d)).astype(np.float32)
            for _ in range(2))
    mask = None
    if masked:
        mask = np.arange(s)[None] < s - 45
    tables = _tables(rng, s, d) if rope else None
    scale = 1.0 / np.sqrt(d)
    jmask = None if mask is None else jnp.asarray(mask)
    jtab = None if tables is None else tuple(jnp.asarray(x) for x in tables)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, kv_mask=jmask, causal=causal,
                                rope=jtab)
        return jnp.sum(o * jnp.asarray(do)), o

    jrope = None if tables is None else (
        jnp.asarray(tables[0]), jfa._rope_signed_sin(jnp.asarray(tables[1])))
    with pltpu.force_tpu_interpret_mode():
        (_, want_o), want = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        _, want_lse = jax.jit(functools.partial(
            jfa._fwd_impl, causal=causal, scale=scale, return_lse=True))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                jrope)

    args = [t(x).requires_grad_() for x in (q, k, v)]
    trope = None if tables is None else tuple(t(x) for x in tables)
    calls = []
    for name in ("flash_forward_lse", "flash_forward_chunked",
                 "flash_bwd_dq", "flash_bwd_dkv"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    o = tfa.flash_attention(*args, kv_mask=t(mask), causal=causal,
                            rope=trope)
    assert o.grad_fn is not None
    (o * t(do)).sum().backward()
    long = s > 256
    assert calls == (["flash_forward_chunked"] if long else
                     ["flash_forward_lse", "flash_bwd_dq", "flash_bwd_dkv"])
    np.testing.assert_allclose(n(o), np.asarray(want_o), **TOL)
    for got, w in zip(args, want):
        np.testing.assert_allclose(n(got.grad), np.asarray(w), **TOL)
    # the lse of the forward kernel on the rotated q and k (the f32 route
    # rotates outside; JAX's _fwd_impl inside its kernel below its limit)
    qr, kr = t(q), t(k)
    if trope is not None:
        qr, kr = (tfa.rope_bhsd(x, *trope) for x in (qr, kr))
    _, lse = (tfa.flash_forward_chunked(qr, kr, t(v), t(mask), causal,
                                        scale, return_lse=True) if long else
              tfa.flash_forward_lse(qr, kr, t(v), t(mask), causal, scale))
    np.testing.assert_allclose(n(lse), np.asarray(want_lse), **TOL)


# ------------------------------------------------------- the slice, tiny

# a tiny FLUX at a head size the kernels take: 2 heads x 64
FLUX_KW = dict(attention_head_dim=64, num_attention_heads=2,
               axes_dims_rope=(16, 24, 24))


def _spy(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(tfa, name)

        def counted(*a, _f=fn, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)
    return calls


def test_tiny_dit_above_max_kv_seq_matches_jax(monkeypatch):
    """One f32 DiT call at 192 image + 64 text tokens with MAX_KV_SEQ
    lowered to 128 in the port: every attention takes K2's route (the qk
    norm and the rope outside, one chunked forward a block), against JAX's
    tiny FLUX on the same weights through its plain reference."""
    monkeypatch.setattr(tfa, "MAX_KV_SEQ", 128)
    cfg = jcfg.tiny_flux_config(**FLUX_KW)
    s_img, s_txt = 192, 64
    img_ids = np.asarray(prepare_latent_image_ids(24, 32))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, s_img, 64)).astype(np.float32)
    ctx = rng.standard_normal((1, s_txt, 64)).astype(np.float32)
    pooled = rng.standard_normal((1, 32)).astype(np.float32)
    tstep = np.array([0.7], np.float32)
    txt_ids = np.zeros((s_txt, 3), np.float32)
    jflux = JFlux(cfg)
    tree = random_tree(jflux.init, x, ctx, pooled, tstep, img_ids, txt_ids,
                       seed=4)
    want = jax.jit(jflux.apply)(tree, x, ctx, pooled, tstep, img_ids,
                                txt_ids)
    flux = load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
        attention_impl="kernel", **FLUX_KW), torch.device("cpu")), tree)
    calls = _spy(monkeypatch, ["flash_forward_chunked"])
    with torch.no_grad():
        got = flux(*(t(a) for a in (x, ctx, pooled, tstep, img_ids,
                                    txt_ids)))
    assert calls["flash_forward_chunked"] == cfg.num_layers + \
        cfg.num_single_layers
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_tiny_phase2_step_matches_jax(monkeypatch):
    """One phase-2 step on a tiny f32 FLUX (1 + 1 blocks, 2 heads x 64,
    remat on, the rope handed to the attention, which rotates outside for
    f32 under autograd) with its bank, VAE and batch from
    ``build_tiny_lightcontrol``: 4 image + 8 text tokens take the pad route
    (K1 with the lse, K3 and K4 on 128 rows with the kv mask, in the
    single block), against
    JAX's step on the same weights and draws (its attention through the
    plain reference): the loss, the grad norm and the bank's gradient as
    each optimizer receives it."""
    flux_kw = dict(num_layers=1, num_single_layers=1, **FLUX_KW)
    jflux_cfg = jcfg.tiny_flux_config(guidance_embeds=True, in_channels=16,
                                      **flux_kw)
    monkeypatch.setattr(tharness, "tiny_flux_config",
                        lambda **kw: tcfg.tiny_flux_config(
                            **kw, **flux_kw, attention_impl="kernel",
                            remat=True))
    vae_cfg = jcfg.VAEConfig(block_out_channels=(8, 8, 8, 8),
                             layers_per_block=1, latent_channels=4,
                             norm_num_groups=4, dtype=jnp.float32,
                             param_dtype=jnp.float32)
    ctrl_cfg, _ = ctrl_cfgs(final=jflux_cfg.inner_dim)
    jflux, jvae = JFlux(jflux_cfg), JVAE(vae_cfg)
    trees = {
        "flux": random_tree(
            functools.partial(jflux.init, guidance=jnp.ones((1,))),
            jnp.zeros((1, 4, 16)), jnp.zeros((1, 8, 64)), jnp.zeros((1, 32)),
            jnp.zeros((1,)), np.asarray(prepare_latent_image_ids(4, 4)),
            jnp.zeros((8, 3)), seed=20),
        "vae": random_tree(jvae.init, jnp.zeros((1, 32, 32, 3)), seed=21),
        "bank": bank_tree(ctrl_cfg, 32, jflux_cfg.num_layers, seed=22)}
    ccfg = jcfg.LightControlConfig(gradient_accumulation_steps=1,
                                   learning_rate=1e-3)
    opt = jlc.make_lightcontrol_optimizer(ccfg)
    jgrads = []

    def update(grads, opt_state, params=None):
        # the bank's gradient, as the optimizer receives it
        jax.debug.callback(lambda g: jgrads.append(jax.tree_util.tree_map(
            np.asarray, g)), grads)
        return opt.update(grads, opt_state, params)

    jstep = jax.jit(jlc.make_lightcontrol_step(
        jflux.apply, lambda px, key: jvae.apply(
            trees["vae"], px, key, method=jvae.encode),
        lambda b: (b["pooled"], b["prompt"]), ctrl_cfg, jflux_cfg, ccfg,
        jcfg.SchedulerConfig(shift=3.0),
        optax.GradientTransformation(opt.init, update)))
    bank = jax.tree_util.tree_map(jnp.asarray, trees["bank"])
    jstate = jlc.ControlTrainState(bank, opt.init(bank),
                                   jnp.zeros((), jnp.int32))

    step, state, batch, parts = tharness.build_tiny_lightcontrol(
        batch_size=2, trees=trees, device="cpu")
    assert parts["flux"].cfg.remat and parts["flux"].cfg.dtype == F32
    key = jax.random.key(5)
    jstate, jm = jstep(jstate, trees["flux"],
                       {k: jnp.asarray(n(v)) for k, v in batch.items()}, key)
    r_vae, r_t, r_noise = jax.random.split(key, 3)
    draws = {"vae": t(jax.random.normal(r_vae, (2, 4, 4, 4), jnp.float32)),
             "density": t(jax.random.normal(r_t, (2,))),
             "noise": t(jax.random.normal(r_noise, (2, 4, 4, 4),
                                          jnp.float32))}
    calls = _spy(monkeypatch, ["flash_forward_lse", "flash_bwd_dq",
                               "flash_bwd_dkv"])
    grads = []
    opt_update = parts["optimizer"].update
    parts["optimizer"].update = lambda params, g, st: (
        grads.extend(x.detach() for x in g), opt_update(params, g, st))[1]
    state, m = step(state, batch, draws)
    # the double block's attention comes before its control is added, so
    # autograd records only the single block's: its forward and its remat
    # recompute, then one backward (on the card: K1's f32 forward once, its
    # lse instance twice, K3's and K4's once)
    assert calls == {"flash_forward_lse": 2, "flash_bwd_dq": 1,
                     "flash_bwd_dkv": 1}
    for key_ in ("loss", "grad_norm"):
        np.testing.assert_allclose(n(m[key_]), n(jm[key_]), **TOL)
    want = load_flax_bank(ControlBank(state.bank.cfg,
                                      len(state.bank.branches)), jgrads[0])
    assert len(grads) == len(list(want.parameters())) > 0
    for got, w in zip(grads, want.parameters()):
        np.testing.assert_allclose(n(got), n(w), **TOL)
