"""The port's int8 modes (x2i_torch/ops/quant.py, the glue kernels' plain
versions in ops/fused_glue.py, the GEMM's plain version in
ops/int8_gemm.py) against the JAX package's on the CPU, on the same numpy
inputs and the same quantized weights.

Tolerances, each with its reason:
* ``quantize_kernel``, the plain products and ``QuantLinear``: bit for
  bit, in float32 and in bf16 (the int32 sums are exact, and the rescale
  and every rounding point are the JAX package's), except w8 in bf16,
  whose bf16 matmul sums in another order: one bf16 step.
* the glue kernels' plain versions against the Pallas kernels in
  interpret mode: the JAX package's own bar (tests/test_fused_glue.py):
  codes within one step, at most 10% flipped, scales within rtol 2e-2;
  K8 has no rounding left but its own and is held bit for bit to the
  quantization inside the JAX ``w8a8_matmul``.
* the tiny FLUX in w8 / w8a8, fused glue on and off: relative L2 at most
  1e-3 in float32 (a code flips where f32 sums in another order cross a
  rounding boundary); in bf16 correlation above 0.999 and relative L2
  below 5e-2, the JAX package's bar for two w8a8 evaluations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _flux_inputs
from test_torch_params import flux_tree, one_thread
from x2i_tpu.core import config as jcfg
from x2i_tpu.models import flux as jflux
from x2i_tpu.models.flux import chunk_single_scan_params
from x2i_tpu.ops import fused_glue as jfg
from x2i_tpu.ops import quant as jq
from jax.experimental.pallas import tpu as pltpu
from x2i_torch.core import config as tcfg
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.ops import fused_glue as tfg
from x2i_torch.ops import int8_gemm as tgemm
from x2i_torch.ops import quant as tq
from x2i_torch.params import load_flax, random_init_

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rows(rng, *shape, mean=3.0):
    """Rows x * sigma + mu, sigma per row over 1e-2..1e2."""
    lead = (*shape[:-1], 1)
    sigma = 10.0 ** rng.uniform(-2, 2, lead)
    mu = sigma * mean * rng.standard_normal(lead)
    return (rng.standard_normal(shape) * sigma + mu).astype(np.float32)


def bf16_grid(a):
    """Round float32 values to the bf16 grid (both packages then hold the
    same values in either dtype)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def assert_codes_close(q, q_ref, max_flip_frac=0.10):
    d = np.abs(np.asarray(q, np.int32) - np.asarray(q_ref, np.int32))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() <= max_flip_frac, (d != 0).mean()


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("shape", [(48, 40), (3, 64, 24), (128, 1)])
def test_quantize_kernel_bit_identical(shape):
    rng = np.random.default_rng(len(shape))
    k = rng.standard_normal(shape).astype(np.float32)
    k[..., 0, :] *= 0.5                      # ties of amax/127 ratios
    if shape[-1] > 1:
        k[..., 1] = 0.0                      # an all-zero channel: 1e-12
    want_q, want_s = jq.quantize_kernel(k)
    got_q, got_s = tq.quantize_kernel(torch.from_numpy(k))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("kernel", ["ln_mod_quant", "gelu_quant",
                                    "quant_rows"])
@pytest.mark.parametrize("seq", [256, 200])   # 200: a ragged final block
def test_glue_plain_matches_pallas_interpret(kernel, seq):
    """K6/K7/K8's plain versions against the Pallas kernels run in
    interpret mode, on bf16 rows spanning four decades, batch 2."""
    rng = np.random.default_rng(seq)
    # gelu's rows are centred: on a row far below zero gelu is ~0
    # everywhere, the scale is the floor 1e-6 / 127, and the ulps in which
    # XLA's and PyTorch's tanh saturate become whole codes
    x = bf16_grid(rows(rng, 2, seq, 128,
                       mean=0.0 if kernel == "gelu_quant" else 3.0))
    xj, xt = jnp.asarray(x, jnp.bfloat16), t(x, torch.bfloat16)
    if kernel == "ln_mod_quant":
        shift, scale = (bf16_grid(rng.standard_normal((2, 128)) * 0.5)
                        for _ in range(2))
        want = jfg.ln_mod_quant(xj, jnp.asarray(shift, jnp.bfloat16),
                                jnp.asarray(scale, jnp.bfloat16),
                                block_rows=64, interpret=True)
        got = tfg.ln_mod_quant(xt, t(shift, torch.bfloat16),
                               t(scale, torch.bfloat16))
    else:
        want = getattr(jfg, kernel)(xj, block_rows=64, interpret=True)
        got = getattr(tfg, kernel)(xt)
    (q, a), (q_ref, a_ref) = got, want
    assert q.dtype == torch.int8 and tuple(q.shape) == (2, seq, 128)
    assert a.dtype == torch.float32 and tuple(a.shape) == (2, seq, 1)
    assert_codes_close(q.numpy(), q_ref)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=2e-2)
    if kernel == "quant_rows":
        # bit for bit the quantization of the JAX w8a8_matmul; the Pallas
        # kernel in interpret mode is not (XLA on the CPU multiplies by a
        # reciprocal of 127 there), hence the bar above
        q_jnp, a_jnp = jfg._row_quantize(xj.astype(jnp.float32))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_jnp))
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_jnp))


def test_quant_rows_takes_two_dims_and_zero_rows():
    """(N, D) rows, as the timestep and adaLN inputs come; an all-zero row
    gets the floor scale 1e-6 / 127 and zero codes."""
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    x[2] = 0.0
    q, a = tfg.quant_rows(t(x))
    q_ref, a_ref = jfg._row_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    assert a[2].item() == np.float32(np.float32(1e-6) / np.float32(127.0))


# -------------------------------------------------------------- products

def _weights(rng, k, nout):
    w = rng.standard_normal((k, nout)).astype(np.float32) / np.sqrt(k)
    qk, s = jq.quantize_kernel(w)
    return qk, s, torch.from_numpy(qk.T.copy()), torch.from_numpy(s)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w8a8_products_match_jax(dtype):
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    qk, s, qw, st = _weights(rng, 96, 40)
    x = bf16_grid(rows(rng, 2, 7, 96))
    want = jq.w8a8_matmul(jnp.asarray(x, jdt), qk, s)
    got = tq.w8a8_matmul(t(x, tdt), qw, st)
    assert got.dtype == tdt
    np.testing.assert_array_equal(n(got), n(want))
    # the exact int32 sum and the prequant form
    xq, a = jfg._row_quantize(jnp.asarray(x, jdt).astype(jnp.float32))
    acc = jax.lax.dot_general(xq, qk, (((2,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    xq_t = torch.from_numpy(np.array(xq))
    got_acc = tgemm.int8_matmul_acc(xq_t, qw)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(acc))
    for out_dtype, tout in ((None, None), (jdt, tdt)):
        want = jq.w8a8_matmul_prequant(xq, a, qk, s, out_dtype=out_dtype)
        got = tq.w8a8_matmul_prequant(xq_t, torch.from_numpy(np.array(a)),
                                      qw, st, out_dtype=tout)
        np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w8_matmul_matches_jax(dtype):
    """The scale is cast to x.dtype before it multiplies the codes. In
    bf16 the two frameworks' bf16 products sum in another order: one bf16
    step of the output's magnitude."""
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    qk, s, qw, st = _weights(rng, 64, 24)
    x = bf16_grid(rng.standard_normal((3, 5, 64)))
    want = n(jq.w8_matmul(jnp.asarray(x, jdt), qk, s))
    got = n(tq.w8_matmul(t(x, tdt), qw, st))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


def _dense_pair(rng, mode, dtype, k, nout):
    """A QuantDense (JAX) and a QuantLinear (port) on the same codes."""
    _, jdt, tdt = DTYPES[dtype]
    qk, s, qw, st = _weights(rng, k, nout)
    bias = bf16_grid(rng.standard_normal(nout) * 0.1)
    dense = jq.QuantDense(nout, dtype=jdt, param_dtype=jdt, mode=mode)
    params = {"params": {"qkernel": qk, "scale": s, "bias": bias}}
    layer = tq.QuantLinear(k, nout, mode=mode, dtype=tdt)
    layer.qweight.copy_(qw)
    layer.scale.copy_(st)
    layer.bias.copy_(t(bias, tdt))
    return dense, params, layer


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quant_linear_tensor_input_matches_quant_dense(mode, dtype):
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    dense, params, layer = _dense_pair(rng, mode, dtype, 64, 48)
    x = bf16_grid(rows(rng, 2, 9, 64))
    want = n(dense.apply(params, jnp.asarray(x, jdt)))
    got = layer(t(x, tdt))
    assert got.dtype == tdt
    if mode == "w8" and dtype == "bf16":
        np.testing.assert_allclose(n(got), want, rtol=2.0 ** -7, atol=1e-6)
    elif mode == "w8":
        np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(n(got), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("widths", [(128,), (48, 80)])
def test_quant_linear_prequant_input_matches_quant_dense(dtype, widths):
    """An (xq, a_scale) pair, and a list of chunks along the input
    features (each a K-slice of the one weight)."""
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(sum(widths) + len(widths))
    dense, params, layer = _dense_pair(rng, "w8a8", dtype, 128, 40)
    chunks_j, chunks_t = [], []
    for w in widths:
        xq, a = jfg.quant_rows(jnp.asarray(bf16_grid(rows(rng, 2, 6, w)),
                                           jnp.bfloat16), interpret=True)
        chunks_j.append((xq, a))
        chunks_t.append((torch.from_numpy(np.array(xq)),
                         torch.from_numpy(np.array(a))))
    arg_j = chunks_j if len(widths) > 1 else chunks_j[0]
    arg_t = chunks_t if len(widths) > 1 else chunks_t[0]
    want = n(dense.apply(params, arg_j))
    got = layer(arg_t)
    assert got.dtype == tdt
    np.testing.assert_array_equal(n(got), want)


def test_quant_linear_refuses_what_it_does_not_take():
    layer = tq.QuantLinear(64, 8, mode="w8")
    xq = torch.zeros((1, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="w8a8"):
        layer((xq, torch.ones((1, 1))))
    layer = tq.QuantLinear(64, 8, mode="w8a8")
    with pytest.raises(ValueError, match="input features"):
        layer([(xq[:, :32], torch.ones((1, 1)))])
    with pytest.raises(NotImplementedError, match="w3"):
        tq.QuantLinear(64, 8, mode="w3")
    with pytest.raises(NotImplementedError):
        tcfg.tiny_flux_config(quantized="w3")
    for impl in ("fast", "kernel"):
        with pytest.raises(ValueError):
            tcfg.tiny_flux_config(quant_impl=impl)


# ---------------------------------------------------------------- bridge

def _quant_tree(seed, mode, chunks=1, bf16=False):
    tree = flux_tree(seed)
    if bf16:
        tree = jax.tree_util.tree_map(bf16_grid, tree)
    return chunk_single_scan_params(jq.quantize_tree(tree, mode), chunks)


@pytest.mark.parametrize("chunks", [1, 2])
def test_bridge_takes_quantize_tree_leaves(chunks):
    """qkernel (in, out) int8 -> qweight (out, in), scale, bias; scan
    stacks and single_blocks_{i} chunk stacks alike."""
    tree = _quant_tree(0, "w8a8", chunks)
    model = load_flax(FluxTransformer2D(
        tcfg.tiny_flux_config(quantized="w8a8")), tree)
    flat = jq.quantize_tree(flux_tree(0), "w8a8")["params"]
    for i, blk in enumerate(model.single_blocks):
        leaf = flat["single_blocks"]["mlp_in"]
        assert blk.mlp_in.qweight.dtype == torch.int8
        np.testing.assert_array_equal(blk.mlp_in.qweight.numpy(),
                                      leaf["qkernel"][i].T)
        np.testing.assert_array_equal(blk.mlp_in.scale.numpy(),
                                      leaf["scale"][i])
        np.testing.assert_array_equal(blk.mlp_in.bias.detach().numpy(),
                                      leaf["bias"][i])
    leaf = flat["x_embedder"]
    np.testing.assert_array_equal(model.x_embedder.qweight.numpy(),
                                  leaf["qkernel"].T)


def test_bridge_refuses_mixed_float_and_int8():
    tree = _quant_tree(0, "w8a8")
    with pytest.raises(KeyError, match="quantized"):
        load_flax(FluxTransformer2D(tcfg.tiny_flux_config()), tree)
    with pytest.raises(KeyError, match="qkernel|kernel"):
        load_flax(FluxTransformer2D(tcfg.tiny_flux_config(quantized="w8")),
                  flux_tree(0))
    # int8 buffers the tree leaves unfilled are reported
    params = jax.tree_util.tree_map(lambda a: a, tree)
    del params["params"]["proj_out"]
    with pytest.raises(KeyError, match="proj_out.qweight"):
        load_flax(FluxTransformer2D(tcfg.tiny_flux_config(quantized="w8a8")),
                  params)


def test_quantize_module_equals_quantize_tree():
    """quantize_module_ on a float model gives the buffers that the bridge
    loads from quantize_tree, and the same outputs; the model's config
    then names the mode."""
    tree = flux_tree(4)
    model = load_flax(FluxTransformer2D(
        tcfg.tiny_flux_config(fused_glue=True)), tree)
    tq.quantize_module_(model, "w8a8")
    ref = load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
        fused_glue=True, quantized="w8a8")), jq.quantize_tree(tree, "w8a8"))
    assert model.cfg.quantized == "w8a8" and model.cfg.glue == "quant"
    assert model.single_blocks[1].cfg.glue == "quant"
    assert not any(isinstance(m, torch.nn.Linear) for m in model.modules())
    got, want = dict(model.named_buffers()), dict(ref.named_buffers())
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    rng = np.random.default_rng(4)
    x = _flux_inputs(rng, jcfg.tiny_flux_config(), 16, 8)
    args = [t(x[k]) for k in ("lat", "txt", "pooled", "t", "img_ids",
                              "txt_ids")]
    with torch.inference_mode():
        assert torch.equal(model(*args), ref(*args))


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_quantize_module_takes_the_route_from_the_config(impl):
    """One field decides the route: every swapped layer takes the model
    config's quant_impl, as the glue does."""
    model = FluxTransformer2D(tcfg.tiny_flux_config(fused_glue=True,
                                                    quant_impl=impl))
    tq.quantize_module_(model, "w8a8")
    layers = [m for m in model.modules() if isinstance(m, tq.QuantLinear)]
    assert layers and all(m.impl == impl for m in layers)
    assert model.cfg.quant_impl == impl and model.cfg.glue == "quant"


def test_random_init_quantizes_a_drawn_weight():
    cfg = tcfg.tiny_flux_config(quantized="w8a8")
    a, b = (random_init_(FluxTransformer2D(cfg),
                         torch.Generator().manual_seed(0)) for _ in range(2))
    w = a.single_blocks[0].q
    assert torch.equal(w.qweight, b.single_blocks[0].q.qweight)
    assert w.qweight.abs().max().item() == 127
    deq = w.qweight.float() * w.scale[:, None]
    assert abs(deq.std().item() - 128 ** -0.5) < 0.01       # 1/sqrt(fan_in)


# ------------------------------------------------------------- tiny FLUX

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_flux_matches_jax(mode, fused, dtype):
    _, jdt, tdt = DTYPES[dtype]
    jc = jcfg.tiny_flux_config(quantized=mode, fused_glue=fused, dtype=jdt,
                               param_dtype=jdt)
    tc = tcfg.tiny_flux_config(quantized=mode, fused_glue=fused, dtype=tdt)
    tree = _quant_tree(5, mode, bf16=dtype == "bf16")
    rng = np.random.default_rng(5)
    x = _flux_inputs(rng, jc, 16, 8)
    args = [x[k] for k in ("lat", "txt", "pooled", "t", "img_ids",
                           "txt_ids")]
    with pltpu.force_tpu_interpret_mode():
        want = n(jax.jit(jflux.FluxTransformer2D(jc).apply)(
            tree, *(jnp.asarray(a) for a in args)))
    model = load_flax(FluxTransformer2D(tc), tree)
    with torch.inference_mode():
        got = n(model(*(t(a) for a in args)))
    assert np.isfinite(got).all() and got.std() > 0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    if dtype == "f32":
        assert rel <= 1e-3, rel
    else:
        corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert corr > 0.999 and rel < 5e-2, (corr, rel)


def test_cpu_quant_wrappers_take_the_plain_path():
    """On CPU tensors K6/K7/K8 and the GEMM run their plain versions: no
    build, no launch counted."""
    rng = np.random.default_rng(10)
    x = t(rows(rng, 1, 8, 128), torch.bfloat16)
    e = t(rng.standard_normal((1, 128)), torch.bfloat16)
    before = dict(tfg.LAUNCHES)
    for got, want in ((tfg.ln_mod_quant(x, e, e),
                       tfg.ln_mod_quant_plain(x, e, e)),
                      (tfg.gelu_quant(x), tfg.gelu_quant_plain(x)),
                      (tfg.quant_rows(x), tfg.quant_rows_plain(x))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    xq, a = tfg.quant_rows_plain(x)
    w = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
    s = torch.rand(64)
    assert torch.equal(tgemm.int8_linear(xq, a, w, s),
                       tgemm.int8_linear_plain(xq, a, w, s))
    assert tfg.LAUNCHES == before
    assert tgemm.GEMM.launches["int8_gemm"] == 0
    assert tgemm.GEMM._lib is None
    assert tfg.ROW_GLUE._lib is None
