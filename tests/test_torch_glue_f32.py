"""The f32 DiT's fused glue in the port against the JAX package on the CPU:
K5 (``ln_mod``) on f32 rows and K1's f32 rope-and-norm forward (the rope
and the qk RMSNorm inside the attention), which an f32 DiT serving with
``fused_glue=True`` takes, as JAX's ``_use_fused_glue`` gives it the "ln"
mode; and K6, K7 and K8 (``ln_mod_quant``, ``gelu_quant``,
``quant_rows``) on f32 rows, the "quant" mode of an f32 w8a8 or w4a8 DiT:

* ``ln_mod_plain`` in f32 against JAX's ``ln_mod`` (the Pallas kernel in
  interpret mode) at the DiT's widths;
* the plain f32 forward with the rope and the qk norm inside
  (``flash_attention`` on CPU tensors, no autograd) against JAX's f32
  ``flash_attention(rope=, qk_norm=)`` in interpret mode;
* a tiny f32 FLUX with ``fused_glue=True`` against JAX's (its kernel route
  in interpret mode), the wrappers spied on to show that K5 and the f32
  rope-and-norm forward are the ones called;
* K6, K7 and K8's plain versions on f32 rows against JAX's kernels in
  interpret mode, at the widths of the 24 x 128 and the 32 x 128 DiT
  (3072, 12288, 4096, 16384), and K8 bit for bit against the quantization
  of JAX's ``w8a8_matmul`` (``_row_quantize``);
* a tiny f32 FLUX in w8a8 and in w4a8 with ``fused_glue=True`` against
  JAX's, the glue wrappers spied on to show that K6, K7 and K8 get f32
  rows;
* K5's f32 argument checks (``row_views``), plain functions that run here
  on CPU tensors without a card.

On the CPU each wrapper runs its plain version; the CUDA kernels are
``tests/test_torch_kernels.py``'s ``cuda`` cases. Inputs from
``np.random.default_rng``. Tolerance: 1e-4 absolute and relative (float32
sums in another order), 2e-5 for ``ln_mod``'s normalized rows; K6-K8 the
JAX package's bar for its glue kernels (``tests/test_torch_quant.py``:
codes within one step, at most 10% flipped, scales within rtol 2e-2; K8
bit for bit); the tiny quantized FLUX 1e-3 relative L2 (a code flips where
f32 sums in another order cross a rounding boundary).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_params import flux_tree, one_thread  # noqa: F401
from test_torch_models import _flux_inputs
from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion.sampling import prepare_latent_image_ids
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.ops import flash_attention as jfa
from x2i_tpu.models.flux import chunk_single_scan_params
from x2i_tpu.ops import fused_glue as jfg
from x2i_tpu.ops import quant as jq
from x2i_tpu.ops.rope import flux_rope_freqs_half
from x2i_torch.core import config as tcfg
from x2i_torch.models import flux as tflux
from x2i_torch.ops import flash_attention as tfa
from x2i_torch.ops import fused_glue as tfg
from x2i_torch.ops import quant as tq
from x2i_torch.params import load_flax

jattn = importlib.import_module("x2i_tpu.ops.attention")
TOL = dict(atol=1e-4, rtol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [(1, 256, 3072), (2, 512, 3072)])
def test_ln_mod_f32_matches_jax(shape):
    """``ln_mod`` on f32 CPU rows (K5's plain version) against JAX's
    ``ln_mod`` in interpret mode: rows whose scale spans four decades, as
    a residual stream has them, f32 out. The modulate multiplies by up to
    2.5 and adds up to 1, so 2e-5 on the output is about 1e-5 on the
    normalized row."""
    b, s, d = shape
    rng = np.random.default_rng(s)
    sigma = 10.0 ** rng.uniform(-2, 2, (b, s, 1))
    x = (rng.standard_normal(shape) * sigma
         + 3 * sigma * rng.standard_normal((b, s, 1))).astype(np.float32)
    shift, scale = (0.5 * rng.standard_normal((b, d)).astype(np.float32)
                    for _ in range(2))
    want = jax.jit(lambda *a: jfg.ln_mod(*a, interpret=True))(
        *(jnp.asarray(a) for a in (x, shift, scale)))
    got = tfg.ln_mod(t(x), t(shift), t(scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("norm", ["per-row", "shared", "none"])
def test_f32_rope_norm_forward_matches_jax(norm):
    """The f32 forward with the rope (and the qk norm) inside, K1's
    rope-and-norm instance's plain version on CPU tensors, against JAX's
    f32 ``flash_attention`` with ``rope`` and ``qk_norm`` (interpret mode):
    the f32 DiT's attention at 4 heads x 128, 256 joint tokens (the
    pipelined body), per-row scales as a double block passes them."""
    s, h, d = 256, 4, 128
    rng = np.random.default_rng(len(norm))
    q, k, v = (rng.standard_normal((1, h, s, d)).astype(np.float32)
               for _ in range(3))
    ids = np.concatenate([np.zeros((s - 64, 3), np.float32),
                          np.asarray(prepare_latent_image_ids(16, 16))])
    tabs = [np.asarray(x) for x in flux_rope_freqs_half(jnp.asarray(ids),
                                                        (16, 56, 56))]
    scales = None
    if norm != "none":
        shape = (s, d) if norm == "per-row" else (d,)
        scales = [(1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
                  for _ in range(2)]
    jnorm = None if scales is None else (*map(jnp.asarray, scales), 1e-6)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda q, k, v: jfa.flash_attention(
            q, k, v, rope=tuple(map(jnp.asarray, tabs)), qk_norm=jnorm))(
                *map(jnp.asarray, (q, k, v)))
    tnorm = None if scales is None else (*map(t, scales), 1e-6)
    with torch.no_grad():
        got = tfa.flash_attention(t(q), t(k), t(v),
                                  rope=tuple(map(t, tabs)), qk_norm=tnorm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


FLUX_KW = dict(attention_head_dim=64, num_attention_heads=2,
               axes_dims_rope=(16, 24, 24), num_layers=1,
               num_single_layers=1, fused_glue=True)


def test_tiny_f32_dit_fused_glue_matches_jax(monkeypatch):
    """One call of a tiny f32 FLUX (1 + 1 blocks, 2 heads x 64, 196 image +
    60 text tokens) with ``fused_glue=True`` on the same weights, JAX on
    its kernel route in interpret mode (``ln_mod`` and flash attention with
    the rope and the qk norm inside, f32): the port's glue is K5 on f32
    rows (4 calls a double block, 1 a single block, 1 the head's) and its
    attention the f32 forward with the rope and the qk norm handed in (one
    a block), both spied on."""
    monkeypatch.setattr(jattn, "_platform", lambda: "tpu")
    jc = jcfg.tiny_flux_config(use_pallas_attention=True, **FLUX_KW)
    s_img, s_txt = 196, 60
    rng = np.random.default_rng(26)
    args = [rng.standard_normal((1, s_img, jc.in_channels)),
            rng.standard_normal((1, s_txt, jc.joint_attention_dim)),
            rng.standard_normal((1, jc.pooled_projection_dim)),
            np.array([0.7]), np.asarray(prepare_latent_image_ids(28, 28)),
            np.zeros((s_txt, 3))]
    args = [np.asarray(a, np.float32) for a in args]
    tree = flux_tree(26, jc, s_img, s_txt)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(JFlux(jc).apply)(tree, *map(jnp.asarray, args))
    model = load_flax(tflux.FluxTransformer2D(tcfg.tiny_flux_config(
        attention_impl="kernel", **FLUX_KW)), tree)
    glue, attn = [], []
    ln_mod, flash = tflux.ln_mod, tfa.flash_attention

    def ln_spy(x, *a, **kw):
        glue.append(x.dtype)
        return ln_mod(x, *a, **kw)

    def flash_spy(q, k, v, **kw):
        attn.append((q.dtype, kw.get("rope") is not None,
                     kw.get("qk_norm") is not None))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(tflux, "ln_mod", ln_spy)
    monkeypatch.setattr(tfa, "flash_attention", flash_spy)
    with torch.inference_mode():
        got = model(*map(t, args))
    n2, n1 = jc.num_layers, jc.num_single_layers
    assert glue == [torch.float32] * (4 * n2 + n1 + 1)
    assert attn == [(torch.float32, True, True)] * (n2 + n1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def _aligned(shape, dtype=torch.float32):
    """A tensor of ``shape`` whose storage starts on a 16-byte boundary (a
    CPU allocation need not): a view into a larger buffer."""
    count = int(np.prod(shape))
    buf = torch.zeros(count + 16, dtype=dtype)
    per16 = 16 // buf.element_size()
    off = (-buf.data_ptr() // buf.element_size()) % per16
    return buf[off:off + count].view(shape)


def _k5_f32_cases():
    x = _aligned((2, 5, 64))
    mod = _aligned((2, 6 * 64))
    wide = _aligned((1, 5, 68))
    return {
        "f32 (B, S, D), chunk(6) rows": ((x, mod[:, :64], mod[:, 64:128]),
                                         None),
        "f32 (N, D) with (1, D) rows": ((x[0], mod[:1, :64],
                                         mod[:1, 64:128]), None),
        "f32 D 12": ((_aligned((3, 12)), _aligned((1, 12)),
                      _aligned((1, 12))), None),
        "f32 D 3072": ((_aligned((1, 2, 3072)), _aligned((1, 3072)),
                        _aligned((1, 3072))), None),
        "f32 D 3076": ((_aligned((1, 2, 3076)), _aligned((1, 3076)),
                        _aligned((1, 3076))), None),
        "f32 D 4096": ((_aligned((1, 2, 4096)), _aligned((1, 4096)),
                        _aligned((1, 4096))), None),
        "f32 D 6144": ((_aligned((1, 2, 6144)), _aligned((1, 6144)),
                        _aligned((1, 6144))), None),
        "f32 D 6": ((_aligned((3, 6)), _aligned((1, 6)), _aligned((1, 6))),
                    "multiple of 4"),
        "f32 unaligned x": ((wide[:, :, 2:66], mod[:1, :64],
                             mod[:1, 64:128]), "16-byte"),
        "f32 x, bf16 shift": ((x, mod[:, :64].to(torch.bfloat16),
                               mod[:, 64:128]), "shift must be"),
        "f16 x": ((x.half(), mod[:, :64].half(), mod[:, 64:128].half()),
                  "bf16 or f32"),
    }


@pytest.mark.parametrize("case", list(_k5_f32_cases()))
def test_k5_f32_row_views(case):
    """Every check K5 takes on f32 rows, on CPU tensors: D a multiple of 4
    (16 bytes), any width, 16-byte row starts, the modulation rows in x's
    dtype; f16 is refused. The wrapper raises these before it builds or
    launches anything, and never drops to the plain version; K6 takes the
    same f32 rows, on K5's group of threads a row."""
    args, error = _k5_f32_cases()[case]
    if error is None:
        x3, shift, scale = tfg.row_views("ln_mod", *args)
        assert x3.dim() == 3 and x3.data_ptr() == args[0].data_ptr()
        assert shift.dtype == scale.dtype == torch.float32
        x6 = tfg.row_views("ln_mod_quant", *args)[0]
        assert x6.data_ptr() == x3.data_ptr()
        d = x3.shape[-1]
        assert 256 % tfg.f32_instance(d)[0] == 0
    else:
        with pytest.raises(ValueError, match=error):
            tfg.row_views("ln_mod", *args)
        with pytest.raises(ValueError, match=error):
            tfg._ln_mod_cuda(*args, 1e-6)
    assert tfg.ROW_GLUE._lib is None


# ------------------------------------------------- K6, K7 and K8 on f32 rows

def _rows(rng, *shape, mean=3.0):
    """f32 rows x * sigma + mu, sigma per row over 1e-2..1e2."""
    lead = (*shape[:-1], 1)
    sigma = 10.0 ** rng.uniform(-2, 2, lead)
    mu = sigma * mean * rng.standard_normal(lead)
    return (rng.standard_normal(shape) * sigma + mu).astype(np.float32)


def _codes_close(q, q_ref, max_flip_frac=0.10):
    d = np.abs(np.asarray(q, np.int32) - np.asarray(q_ref, np.int32))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() <= max_flip_frac, (d != 0).mean()


@pytest.mark.parametrize("width", [3072, 12288, 4096, 16384])
@pytest.mark.parametrize("kernel", ["ln_mod_quant", "gelu_quant",
                                    "quant_rows"])
def test_quant_glue_f32_matches_jax(kernel, width):
    """K6, K7 and K8's plain versions on f32 CPU rows (the f32 instances'
    function) against JAX's kernels in interpret mode on the same f32
    rows, batch 2, 20 rows (a ragged last block of 8): codes, f32 scales
    of x's shape; K8 bit for bit the quantization of JAX's
    ``w8a8_matmul`` too."""
    rng = np.random.default_rng(width + len(kernel))
    x = _rows(rng, 2, 20, width, mean=0.0 if kernel == "gelu_quant" else 3.0)
    xj = jnp.asarray(x)
    if kernel == "ln_mod_quant":
        shift, scale = (0.5 * rng.standard_normal((2, width)).astype(
            np.float32) for _ in range(2))
        want = jax.jit(lambda *a: jfg.ln_mod_quant(
            *a, block_rows=8, interpret=True))(xj, jnp.asarray(shift),
                                               jnp.asarray(scale))
        got = tfg.ln_mod_quant(t(x), t(shift), t(scale))
    else:
        want = jax.jit(lambda a: getattr(jfg, kernel)(
            a, block_rows=8, interpret=True))(xj)
        got = getattr(tfg, kernel)(t(x))
    (q, a), (q_ref, a_ref) = got, want
    assert q.dtype == torch.int8 and tuple(q.shape) == x.shape
    assert a.dtype == torch.float32 and tuple(a.shape) == (2, 20, 1)
    _codes_close(q.numpy(), q_ref)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=2e-2)
    if kernel == "quant_rows":
        q_jnp, a_jnp = jfg._row_quantize(xj)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_jnp))
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_jnp))


@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
def test_tiny_f32_quant_dit_fused_glue_matches_jax(mode, monkeypatch):
    """One call of a tiny f32 FLUX (2 + 4 blocks) in w8a8 and in w4a8 with
    ``fused_glue=True`` on the same quantized tree as JAX's (its "quant"
    glue, the Pallas kernels in interpret mode): K6 gets f32 rows 4 times
    a double block, once a single block and once for the head, K7 twice a
    double block and once a single block, K8 for the attention outputs
    (2 a double block, 1 a single) and for every layer fed unfused (the
    7 embedder and head layers and the blocks' adaLN layers), all spied
    on; the output within 1e-3 relative L2 of JAX's."""
    jc = jcfg.tiny_flux_config(quantized=mode, fused_glue=True,
                               dtype=jnp.float32, param_dtype=jnp.float32)
    tc = tcfg.tiny_flux_config(quantized=mode, fused_glue=True)
    # the tree and inputs of test_torch_quant.py's tiny quantized FLUX
    tree = chunk_single_scan_params(jq.quantize_tree(flux_tree(5), mode), 1)
    x = _flux_inputs(np.random.default_rng(5), jc, 16, 8)
    args = [np.asarray(x[k], np.float32) for k in (
        "lat", "txt", "pooled", "t", "img_ids", "txt_ids")]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(JFlux(jc).apply)(
            tree, *map(jnp.asarray, args)))
    model = load_flax(tflux.FluxTransformer2D(tc), tree)
    calls = {"ln_mod_quant": [], "gelu_quant": [], "quant_rows": []}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(x, *a, **kw):
            calls[name].append(x.dtype)
            return fn(x, *a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    for name in calls:
        spy(tflux, name)
    spy(tq, "quant_rows")
    with torch.inference_mode():
        got = n(model(*map(t, args)))
    n2, n1 = tc.num_layers, tc.num_single_layers
    assert calls == {
        "ln_mod_quant": [torch.float32] * (4 * n2 + n1 + 1),
        "gelu_quant": [torch.float32] * (2 * n2 + n1),
        "quant_rows": [torch.float32] * ((2 * n2 + n1) + 7 + (2 * n2 + n1))}
    assert np.isfinite(got).all() and got.std() > 0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-3, rel
