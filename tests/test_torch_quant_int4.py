"""The port's int4 modes w4 and w4a8 (x2i_torch/ops/quant.py, the plain
versions of ops/int4_gemm.py) against the JAX package's on the CPU, on the
same numpy inputs and the same quantized weights.

Tolerances, each with its reason:
* the quantizers, packing and unpacking, ``_dequant_w4``: bit for bit
  (the same IEEE divisions, round half to even, f32 clamps);
* ``w4a8_matmul``, ``w4a8_matmul_prequant`` and ``QuantLinear`` in w4a8:
  bit for bit in f32 and bf16 (the int32 sums are exact, and the rescale
  and every rounding point are the JAX package's);
* ``w4_matmul`` and ``QuantLinear`` in w4: 2e-5 in f32 (the two float
  products sum in another order), one bf16 step in bf16;
* ``quantize_kernel_w4_awq``: the same alpha and codes (its error sums
  in another order, far from a tie on these inputs);
* the tiny FLUX in w4 / w4a8, fused glue on and off: the bars of the
  int8 modes' tiny-FLUX test (tests/test_torch_quant.py). Relative L2 at
  most 1e-3 in float32 where no code is computed at run time (w4: the
  float sums differ in order only); correlation above 0.999 and relative
  L2 below 5e-2, the JAX package's bar for two evaluations that quantize
  activations, in bf16 and in w4a8. In w4a8 an activation code flips
  where the f32 attention and LayerNorm sums, taken in another order,
  cross a rounding boundary: w4a8 unfused in float32 measured 5.9e-3 at
  this seed (the int8 test's w8a8 measures 1.3e-3 at seed 6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _flux_inputs
from test_torch_params import flux_tree
from x2i_tpu.core import config as jcfg
from x2i_tpu.models import flux as jflux
from x2i_tpu.models.flux import chunk_single_scan_params
from x2i_tpu.ops import fused_glue as jfg
from x2i_tpu.ops import quant as jq
from jax.experimental.pallas import tpu as pltpu
from x2i_torch.core import config as tcfg
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.ops import int4_gemm as t4
from x2i_torch.ops import int8_gemm as tgemm
from x2i_torch.ops import quant as tq
from x2i_torch.params import load_flax, random_init_

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ARGS = ("lat", "txt", "pooled", "t", "img_ids", "txt_ids")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models' small ops on one thread: with the test run's
    workers on every core, torch's thread pool made them several times
    slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _tree(seed):
    """The tiny FLUX's random tree, built once a module (read only)."""
    return flux_tree(seed)


@functools.lru_cache(maxsize=None)
def _quantized(seed, mode, group=128):
    """JAX's ``quantize_tree`` of ``_tree(seed)``, once a module (read
    only: eager JAX compiles each of its ops apart)."""
    return jq.quantize_tree(_tree(seed), mode, group=group)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def i8(a):
    return torch.from_numpy(np.array(a, np.int8))


def bf16_grid(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def rows(rng, *shape, mean=3.0):
    """Rows x * sigma + mu, sigma per row over 1e-2..1e2."""
    lead = (*shape[:-1], 1)
    sigma = 10.0 ** rng.uniform(-2, 2, lead)
    mu = sigma * mean * rng.standard_normal(lead)
    return (rng.standard_normal(shape) * sigma + mu).astype(np.float32)


def kernel_of(rng, shape):
    """Weights with a spread of group maxima, a zero channel (the clamps)
    and ties of amax / 7 ratios."""
    k = (rng.standard_normal(shape)
         * 10.0 ** rng.uniform(-1, 1, (*shape[:-2], 1, shape[-1])))
    k = k.astype(np.float32)
    k[..., 1] = 0.0
    k[..., 0, :] *= 0.5
    return k


# (in, out) and a scan stack; 64: w4a8 halves the one group to 32; 384:
# three groups of 128, an odd count w4a8 halves to six of 64
SHAPES = [(64, 24), (256, 16), (3072, 8), (384, 12), (2, 256, 8)]


def _jax_quantize(mode, k):
    if mode == "w4":
        return jq.quantize_kernel_w4(k)
    return jq.quantize_kernel_w4a8(k)


def _torch_quantize(mode, k):
    if mode == "w4":
        return tq.quantize_kernel_w4(torch.from_numpy(k))
    return tq.quantize_kernel_w4a8(torch.from_numpy(k))


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_int4_quantizers_bit_identical(mode, shape):
    k = kernel_of(np.random.default_rng(sum(shape)), shape)
    want = _jax_quantize(mode, k)
    got = _torch_quantize(mode, k)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == {np.int8: torch.int8,
                           np.float32: torch.float32}[w.dtype.type]
        np.testing.assert_array_equal(g.numpy(), w)


def test_int4_group_sizes_match_jax():
    for inn in (64, 96, 256, 384, 640, 3072, 15360):
        assert tq._w4_group(inn, 128) == jq._w4_group(inn, 128)
        assert tq._w4a8_group(inn, 128) == jq._w4a8_group(inn, 128)
    assert tq._w4a8_group(64, 128) == 32


def test_pack_and_unpacks_round_trip():
    """pack_int4 is JAX's; both unpacks give the codes back, each from
    its own packing; _w4a8_weight_int8 and _dequant_w4 are JAX's."""
    rng = np.random.default_rng(7)
    q = rng.integers(-8, 8, (2, 64, 12)).astype(np.int8)
    packed = tq.pack_int4(i8(q))
    np.testing.assert_array_equal(packed.numpy(), jq.pack_int4(q))
    np.testing.assert_array_equal(tq._unpack_int4(packed).numpy(), q)
    # the half-split packing of quantize_kernel_w4a8: lo, hi halves
    half = tq._pack(i8(q[:, :32]), i8(q[:, 32:]))
    lo, hi = tq._w4a8_codes(half)
    np.testing.assert_array_equal(torch.cat([lo, hi], 1).numpy(), q)
    jlo, jhi = jq._w4a8_codes(jnp.asarray(half.numpy()))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    m = rng.integers(1, 16, (2, 4, 12)).astype(np.int8)
    np.testing.assert_array_equal(
        tq._w4a8_scaled(lo, i8(m[:, :2])).numpy(),
        np.asarray(jq._w4a8_scaled(jlo, jnp.asarray(m[:, :2]))))
    np.testing.assert_array_equal(
        tq._w4a8_weight_int8(half, i8(m)).numpy(),
        np.asarray(jq._w4a8_weight_int8(jnp.asarray(half.numpy()),
                                        jnp.asarray(m))))
    scale = (rng.uniform(0.5, 2.0, (2, 2, 12)) / 7).astype(np.float32)
    for jdt, tdt in DTYPES.values():
        want = jq._dequant_w4(jnp.asarray(packed.numpy()), jnp.asarray(scale),
                              jdt)
        got = tq._dequant_w4(packed, torch.from_numpy(scale), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(n(got), n(want))


# -------------------------------------------------------------- products

def _w4a8_weights(rng, inn, nout):
    k = rng.standard_normal((inn, nout)).astype(np.float32) / np.sqrt(inn)
    pk, m, s = jq.quantize_kernel_w4a8(k)
    return (pk, m, s), (i8(pk.T), i8(m), torch.from_numpy(s))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w4a8_matmul_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    jw, tw = _w4a8_weights(rng, 256, 40)
    x = bf16_grid(rows(rng, 2, 7, 256))
    want = jq.w4a8_matmul(jnp.asarray(x, jdt), *jw)
    got = tq.w4a8_matmul(t(x, tdt), *tw)
    assert got.dtype == tdt
    np.testing.assert_array_equal(n(got), n(want))


# (row0, width) chunks of a 512-wide weight (in/2 = 256, groups of 128):
# all low, across the half, all high, the whole
PREQUANT_CHUNKS = [(0, 128), (128, 256), (256, 256), (384, 128), (0, 512)]


@pytest.mark.parametrize("row0,width", PREQUANT_CHUNKS)
def test_w4a8_matmul_prequant_row0_matches_jax(row0, width):
    rng = np.random.default_rng(row0 + width)
    jw, tw = _w4a8_weights(rng, 512, 24)
    xq, a = jfg._row_quantize(jnp.asarray(rows(rng, 2, 5, width)))
    xq_t, a_t = torch.from_numpy(np.array(xq)), torch.from_numpy(np.array(a))
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = jq.w4a8_matmul_prequant(xq, a, *jw, row0=row0, out_dtype=jdt)
        got = tq.w4a8_matmul_prequant(xq_t, a_t, *tw, row0=row0,
                                      out_dtype=tdt)
        np.testing.assert_array_equal(n(got), n(want))
    # the exact int32 sum of the materialized operand's slice
    acc = t4.w4a8_matmul_acc(xq_t, *tw[:2], k0=row0)
    codes = np.asarray(jq._w4a8_weight_int8(jnp.asarray(jw[0]),
                                            jnp.asarray(jw[1])), np.int64)
    want = np.array(xq, np.int64) @ codes[row0:row0 + width]
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w4_matmul_matches_jax(dtype):
    """In f32 within 2e-5 (the float products sum in another order); in
    bf16 one bf16 step of the output's magnitude."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    k = rng.standard_normal((256, 24)).astype(np.float32) / 16
    pk, sc = jq.quantize_kernel_w4(k)
    x = bf16_grid(rng.standard_normal((3, 5, 256)))
    want = n(jq.w4_matmul(jnp.asarray(x, jdt), pk, sc))
    got = n(tq.w4_matmul(t(x, tdt), i8(pk.T), torch.from_numpy(sc)))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5)


# ---------------------------------------------------------- QuantLinear

def _dense_pair(rng, mode, dtype, k, nout, pre_scale=False):
    """A QuantDense (JAX) and a QuantLinear (port) on the same weights:
    the JAX tree, loaded into the layer through its buffers."""
    jdt, tdt = DTYPES[dtype]
    w = rng.standard_normal((k, nout)).astype(np.float32) / np.sqrt(k)
    leaves = jq.quantize_tree({"d": {"kernel": w}}, mode)["d"]
    if pre_scale:
        leaves["pre_scale"] = rng.uniform(0.5, 2.0, k).astype(np.float32)
    leaves["bias"] = bf16_grid(rng.standard_normal(nout) * 0.1)
    dense = jq.QuantDense(nout, dtype=jdt, param_dtype=jdt, mode=mode)
    layer = tq.QuantLinear(k, nout, mode=mode, dtype=tdt)
    load_flax(torch.nn.ModuleDict({"d": layer}), {"d": leaves})
    return dense, {"params": leaves}, layer


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_quant_linear_int4_tensor_input_matches_quant_dense(mode, dtype):
    rng = np.random.default_rng(3)
    dense, params, layer = _dense_pair(rng, mode, dtype, 256, 48,
                                       pre_scale=mode == "w4")
    jdt, tdt = DTYPES[dtype]
    x = bf16_grid(rows(rng, 2, 9, 256))
    want = n(dense.apply(params, jnp.asarray(x, jdt)))
    got = layer(t(x, tdt))
    assert got.dtype == tdt
    if mode == "w4a8":
        np.testing.assert_array_equal(n(got), want)
    else:
        scale = np.abs(want).max()
        tol = 2.0 ** -7 if dtype == "bf16" else 2e-5
        np.testing.assert_allclose(n(got), want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("widths", [(640,), (128, 512), (384, 256)])
def test_quant_linear_w4a8_prequant_input_matches_quant_dense(dtype,
                                                               widths):
    """An (xq, a_scale) pair, and chunks along the input features of a
    640-wide weight (groups of 64, in/2 = 320): the single block's output
    layer, and a chunk across the half."""
    rng = np.random.default_rng(sum(widths) + len(widths))
    dense, params, layer = _dense_pair(rng, "w4a8", dtype, 640, 40)
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
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(n(got), want)


def test_quant_linear_int4_refuses_what_it_does_not_take():
    """A w4a8 chunk off a group boundary raises, as in JAX; w4 takes no
    pre-quantized input; an odd input dim has no int4 packing."""
    layer = tq.QuantLinear(256, 8, mode="w4a8")
    xq, a = torch.zeros((1, 256), dtype=torch.int8), torch.ones((1, 1))
    with pytest.raises(ValueError, match="group-aligned"):
        layer([(xq[:, :64], a), (xq[:, 64:], a)])
    with pytest.raises(ValueError, match="input features"):
        layer([(xq[:, :128], a)])
    with pytest.raises(ValueError, match="w4a8"):
        tq.QuantLinear(256, 8, mode="w4")((xq, a))
    for mode in ("w4", "w4a8"):
        with pytest.raises(ValueError, match="even"):
            tq.QuantLinear(63, 8, mode=mode)


def test_awq_picks_the_same_alpha_and_codes():
    rng = np.random.default_rng(11)
    k = rng.standard_normal((256, 32)).astype(np.float32) / 16
    amax = np.abs(rng.standard_normal(256)) * 10.0 ** rng.uniform(-1, 1, 256)
    want = jq.quantize_kernel_w4_awq(k, amax, n_grid=8)
    got = tq.quantize_kernel_w4_awq(torch.from_numpy(k), amax, n_grid=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------ bridge and trees

@functools.lru_cache(maxsize=None)
def _int4_tree(seed, mode, chunks=1, bf16=False):
    if not bf16:
        return chunk_single_scan_params(_quantized(seed, mode), chunks)
    tree = jax.tree_util.tree_map(bf16_grid, _tree(seed))
    return chunk_single_scan_params(jq.quantize_tree(tree, mode), chunks)


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_bridge_takes_int4_leaves(mode, chunks):
    """pkernel (in/2, out) -> pweight (out, in/2); mscale, scale and
    pre_scale in the JAX layout; scan stacks and chunk stacks alike. A
    tree of the other int4 mode is refused by its leaves."""
    model = load_flax(FluxTransformer2D(
        tcfg.tiny_flux_config(quantized=mode)), _int4_tree(0, mode, chunks))
    flat = _quantized(0, mode)["params"]
    extra = "mscale" if mode == "w4a8" else "pre_scale"
    for i, blk in enumerate(model.single_blocks):
        leaf = flat["single_blocks"]["out"]
        np.testing.assert_array_equal(blk.out.pweight.numpy(),
                                      leaf["pkernel"][i].T)
        np.testing.assert_array_equal(blk.out.scale.numpy(),
                                      leaf["scale"][i])
        np.testing.assert_array_equal(getattr(blk.out, extra).numpy(),
                                      leaf[extra][i])
    np.testing.assert_array_equal(model.x_embedder.pweight.numpy(),
                                  flat["x_embedder"]["pkernel"].T)
    other = "w4" if mode == "w4a8" else "w4a8"
    with pytest.raises(KeyError, match="unexpected leaves"):
        load_flax(FluxTransformer2D(tcfg.tiny_flux_config(quantized=other)),
                  _int4_tree(0, mode))


@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_quantize_module_equals_quantize_tree_int4(mode):
    """Both orders give the same pweight / mscale / scale: the port's
    quantize_module_ on float weights, and JAX's quantize_tree on the same
    weights followed by the bridge; and the same outputs."""
    tree = _tree(4)
    model = load_flax(FluxTransformer2D(
        tcfg.tiny_flux_config(fused_glue=True)), tree)
    tq.quantize_module_(model, mode)
    ref = load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
        fused_glue=True, quantized=mode)), _quantized(4, mode))
    assert model.cfg.quantized == mode
    assert model.cfg.glue == ("quant" if mode == "w4a8" else "ln")
    got, want = dict(model.named_buffers()), dict(ref.named_buffers())
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    x = _flux_inputs(np.random.default_rng(4), jcfg.tiny_flux_config(), 16, 8)
    args = [t(x[k]) for k in ARGS]
    with torch.inference_mode():
        assert torch.equal(model(*args), ref(*args))


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4", "w4a8"])
def test_dequantize_module_matches_dequantize_tree(mode):
    """dequantize_module_ gives the float Linear weights of JAX's
    dequantize_tree (w4 with a pre_scale folded in), bit for bit."""
    tree = jq.quantize_tree(_tree(6), mode)
    if mode == "w4":
        rng = np.random.default_rng(6)
        ps = tree["params"]["single_blocks"]["mlp_in"]["pre_scale"]
        tree["params"]["single_blocks"]["mlp_in"]["pre_scale"] = \
            rng.uniform(0.5, 2.0, ps.shape).astype(np.float32)
    model = load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
        quantized=mode, fused_glue=True)), tree)
    tq.dequantize_module_(model)
    assert model.cfg.quantized is False and model.cfg.glue == "ln"
    assert not any(isinstance(m, tq.QuantLinear) for m in model.modules())
    ref = load_flax(FluxTransformer2D(tcfg.tiny_flux_config(
        fused_glue=True)), jq.dequantize_tree(tree))
    got, want = model.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_random_init_quantizes_a_drawn_int4_weight():
    for mode in ("w4", "w4a8"):
        m = random_init_(FluxTransformer2D(tcfg.tiny_flux_config(
            quantized=mode)), torch.Generator().manual_seed(0))
        w = m.single_blocks[0].q.dequantized_weight()
        assert abs(w.std().item() - 128 ** -0.5) < 0.02      # 1/sqrt(fan_in)


# ------------------------------------------------------------- tiny FLUX

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_int4_flux_matches_jax(mode, fused, dtype):
    jdt, tdt = DTYPES[dtype]
    jc = jcfg.tiny_flux_config(quantized=mode, fused_glue=fused, dtype=jdt,
                               param_dtype=jdt)
    tc = tcfg.tiny_flux_config(quantized=mode, fused_glue=fused, dtype=tdt)
    tree = _int4_tree(5, mode, bf16=dtype == "bf16")
    x = _flux_inputs(np.random.default_rng(5), jc, 16, 8)
    args = [x[k] for k in ARGS]
    with pltpu.force_tpu_interpret_mode():
        want = n(jax.jit(jflux.FluxTransformer2D(jc).apply)(
            tree, *(jnp.asarray(a) for a in args)))
    model = load_flax(FluxTransformer2D(tc), tree)
    with torch.inference_mode():
        got = n(model(*(t(a) for a in args)))
    assert np.isfinite(got).all() and got.std() > 0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    if dtype == "f32" and mode == "w4":
        assert rel <= 1e-3, rel
    else:
        corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert corr > 0.999 and rel < 5e-2, (corr, rel)


def test_cpu_int4_wrappers_take_the_plain_path():
    """On CPU tensors the w4a8 GEMM and the dequantize kernel run their
    plain versions: no build, no launch counted."""
    rng = np.random.default_rng(10)
    _, (pw, m, s) = _w4a8_weights(rng, 256, 64)
    xq = torch.randint(-127, 128, (8, 256), dtype=torch.int8)
    a = torch.rand(8, 1)
    assert torch.equal(t4.w4a8_linear(xq, a, pw, m, s),
                       t4.w4a8_linear_plain(xq, a, pw, m, s))
    sc = torch.rand(2, 64)
    assert torch.equal(t4.w4_dequant(pw, sc), t4.w4_dequant_plain(pw, sc))
    assert tgemm.GEMM.launches["w4a8_gemm"] == 0
    assert tgemm.GEMM.launches["w4_dequant"] == 0
    assert tgemm.GEMM._lib is None


# ------------------------------------------------- groups other than 128

# group 64 (the (192, 16) shape: three groups of 64, an odd count that
# w4a8 halves to six of 32), and a group of 48 beside it
GROUP_SHAPES = [(64, (192, 16)), (64, (256, 8)), (64, (2, 128, 8)),
                (48, (96, 12))]


@pytest.mark.parametrize("group,shape", GROUP_SHAPES)
@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_int4_quantizers_bit_identical_at_other_groups(mode, group, shape):
    k = kernel_of(np.random.default_rng(group + sum(shape)), shape)
    jfn = jq.quantize_kernel_w4 if mode == "w4" else jq.quantize_kernel_w4a8
    tfn = tq.quantize_kernel_w4 if mode == "w4" else tq.quantize_kernel_w4a8
    want = jfn(k, group)
    got = tfn(torch.from_numpy(k), group)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if mode == "w4a8" and shape == (192, 16):
        assert got[1].shape == (6, 16)                 # halved to 32


def _quant_dense_at(group):
    """The JAX QuantDense with another default group, for the JAX models
    that build their layers through ``make_dense`` (no group argument)."""
    return type(f"QuantDense{group}", (jq.QuantDense,),
                {"__annotations__": {"group": int}, "group": group})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_quant_linear_at_group_64_matches_quant_dense(mode, dtype):
    """QuantLinear(group=64), quantize_module_(group=64) and the bridge of
    a ``quantize_tree(group=64)`` leaf against QuantDense(group=64), at a
    width where w4a8 halves the group (192 = 3 x 64 -> 6 x 32)."""
    rng = np.random.default_rng(20)
    jdt, tdt = DTYPES[dtype]
    w = bf16_grid(rng.standard_normal((192, 40)) / np.sqrt(192))
    leaves = jq.quantize_tree({"d": {"kernel": w}}, mode, group=64)["d"]
    leaves["bias"] = bf16_grid(rng.standard_normal(40) * 0.1)
    dense = jq.QuantDense(40, dtype=jdt, param_dtype=jdt, mode=mode,
                          group=64)
    bridged = tq.QuantLinear(192, 40, mode=mode, dtype=tdt)   # group 128
    load_flax(torch.nn.ModuleDict({"d": bridged}), {"d": leaves})
    assert bridged.group == (32 if mode == "w4a8" else 64)
    lin = torch.nn.Linear(192, 40, dtype=tdt)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(leaves["bias"]))
    swapped = tq.quantize_module_(torch.nn.ModuleDict({"d": lin}), mode,
                                  group=64)["d"]
    direct = tq.QuantLinear.from_linear(lin, mode, group=64)
    for layer in (swapped, direct):
        assert layer.group == bridged.group
        for k, v in [*bridged.named_buffers(), ("bias", bridged.bias)]:
            assert torch.equal(getattr(layer, k), v), k
    x = bf16_grid(rows(rng, 2, 7, 192))
    want = n(dense.apply({"params": leaves}, jnp.asarray(x, jdt)))
    got = n(bridged(t(x, tdt)))
    if mode == "w4a8":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 2.0 ** -7 if dtype == "bf16" else 2e-5
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def test_set_groups_refuses_groups_that_do_not_split():
    with pytest.raises(ValueError, match="groups"):
        tq.QuantLinear(192, 8, mode="w4a8").set_groups_(3)
    with pytest.raises(ValueError, match="groups"):
        tq.QuantLinear(192, 8, mode="w4").set_groups_(5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["w4", "w4a8"])
def test_int4_flux_at_group_64_matches_jax(monkeypatch, mode, fused):
    """A JAX tree quantized by ``quantize_tree(..., group=64)`` loads into
    the port (the tiny FLUX's 64-wide context embedder is one group, which
    w4a8 halves to two of 32; the 128-wide layers take two groups) and the
    two compute the same tiny FLUX, on the bars of the group-128 test. JAX's
    FLUX builds QuantDense at its default group, which the test sets to
    64."""
    monkeypatch.setattr(jq, "QuantDense", _quant_dense_at(64))
    jc = jcfg.tiny_flux_config(quantized=mode, fused_glue=fused)
    tc = tcfg.tiny_flux_config(quantized=mode, fused_glue=fused)
    tree = _quantized(7, mode, 64)
    x = _flux_inputs(np.random.default_rng(7), jc, 16, 8)
    args = [x[k] for k in ARGS]
    with pltpu.force_tpu_interpret_mode():
        want = n(jax.jit(jflux.FluxTransformer2D(jc).apply)(
            tree, *(jnp.asarray(a) for a in args)))
    model = load_flax(FluxTransformer2D(tc), tree)
    ce = model.context_embedder
    assert ce.group == (32 if mode == "w4a8" else 64)
    assert model.single_blocks[0].q.group == 64
    with torch.inference_mode():
        got = n(model(*(t(a) for a in args)))
    assert np.isfinite(got).all() and got.std() > 0
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    if mode == "w4":
        assert rel <= 1e-3, rel
    else:
        corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert corr > 0.999 and rel < 5e-2, (corr, rel)
