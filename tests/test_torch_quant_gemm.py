"""The dequantizing GEMM of the weight-only modes w8 and w4
(``x2i_torch/ops/int4_gemm.py::dequant_linear``), ``QuantLinear``'s route
through it and the w4 layer's identity pre-scale, on the CPU against the
JAX package's ``w8_matmul`` and ``w4_matmul``.

On a CPU tensor the wrapper takes its plain version (the kernel itself is
held against it on the card by ``chip_smoke.py``). Tolerances, each with
its reason:
* the dequantized weight: bit for bit (the code and the scale cast to the
  dtype, one product in it, as JAX's XLA fusion computes it);
* the product against JAX's: relative L2 at most 1e-5 in f32 and 1e-2 in
  bf16 (the two packages' CPU products sum in another order);
* ``QuantLinear`` against the plain function, and the skipped identity
  pre-scale against the multiply: bit for bit (the same operations; x * 1
  is x).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x2i_tpu.ops import quant as jq
from x2i_torch.ops import int4_gemm as t4
from x2i_torch.ops import int8_gemm as tgemm
from x2i_torch.ops import quant as tq
from x2i_torch.params import load_flax

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
REL_L2 = {"f32": 1e-5, "bf16": 1e-2}
# mode and w4 group size
MODES = [("w8", None), ("w4", 32), ("w4", 64), ("w4", 128)]


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def bf16_grid(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _weights(rng, mode, group, k, nout):
    """JAX's codes and scales of a random (k, nout) kernel -> (the JAX
    leaves (codes, scale), the port's (codes (N, ...), scale))."""
    w = rng.standard_normal((k, nout)).astype(np.float32) / np.sqrt(k)
    if mode == "w8":
        qk, s = jq.quantize_kernel(w)
    else:
        qk, s = jq.quantize_kernel_w4(w, group)
    qk, s = np.asarray(qk), np.asarray(s)
    return (qk, s), (torch.from_numpy(qk.T.copy()), torch.from_numpy(s))


def _jax_product(mode, x, codes, scale):
    fn = jq.w8_matmul if mode == "w8" else jq.w4_matmul
    return fn(x, jnp.asarray(codes), jnp.asarray(scale))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode,group", MODES)
def test_dequantized_weight_is_jax_bit_for_bit(mode, group, dtype):
    jdt, tdt = DTYPES[dtype]
    (qk, s), (codes, scale) = _weights(np.random.default_rng(1), mode,
                                       group, 256, 24)
    if mode == "w8":
        want = jnp.asarray(qk).astype(jdt) * jnp.asarray(s).astype(jdt)
    else:
        want = jq._dequant_w4(jnp.asarray(qk), jnp.asarray(s), jdt)
    got = t4.dequant_weight_plain(codes, scale, mode, tdt)
    assert got.dtype == tdt and got.shape == (24, 256)
    np.testing.assert_array_equal(n(got).T, n(want))
    # on a CPU tensor the kernel's dump of its converted weight is the same
    x = torch.zeros((1, 256), dtype=tdt)
    assert torch.equal(t4.dequant_gemm_weight(x, codes, scale, mode), got)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("rows", [1, 7])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode,group", MODES)
def test_dequant_linear_plain_matches_jax(mode, group, dtype, rows, bias):
    """Odd row counts (one row: the adaLN and timestep rows), with the
    bias added in the dtype after the product, as ``QuantDense`` does."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(rows + 3 * bias)
    (qk, s), (codes, scale) = _weights(rng, mode, group, 384, 40)
    x = bf16_grid(rng.standard_normal((rows, 384)) * 2)
    b = bf16_grid(rng.standard_normal(40) * 0.1) if bias else None
    want = _jax_product(mode, jnp.asarray(x, jdt), qk, s)
    if bias:
        want = want + jnp.asarray(b).astype(jdt)
    got = t4.dequant_linear(torch.from_numpy(x).to(tdt), codes, scale,
                            None if b is None else torch.from_numpy(b),
                            mode)
    assert got.dtype == tdt and got.shape == (rows, 40)
    want = n(want)
    rel = np.linalg.norm(n(got) - want) / np.linalg.norm(want)
    assert rel <= REL_L2[dtype], rel


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["w8", "w4"])
def test_quant_linear_takes_the_dequantizing_product(mode, dtype):
    """On the CPU a w8 / w4 ``QuantLinear`` is the plain dequantizing
    product of its own buffers and bias, bit for bit, and JAX's
    ``QuantDense`` within the product's tolerance; no kernel is built or
    counted."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    w = rng.standard_normal((256, 48)).astype(np.float32) / 16
    leaves = jq.quantize_tree({"d": {"kernel": w}}, mode)["d"]
    leaves["bias"] = bf16_grid(rng.standard_normal(48) * 0.1)
    layer = tq.QuantLinear(256, 48, mode=mode, dtype=tdt)
    load_flax(torch.nn.ModuleDict({"d": layer}), {"d": leaves})
    x = torch.from_numpy(bf16_grid(rng.standard_normal((2, 5, 256)))).to(tdt)
    got = layer(x)
    plain = t4.dequant_linear_plain(x, *layer.codes(), layer.bias, mode)
    assert torch.equal(got, plain)
    dense = jq.QuantDense(48, dtype=jdt, param_dtype=jdt, mode=mode)
    want = n(dense.apply({"params": leaves}, jnp.asarray(n(x), jdt)))
    rel = np.linalg.norm(n(got) - want) / np.linalg.norm(want)
    assert rel <= REL_L2[dtype], rel
    assert tgemm.GEMM.launches["dequant_gemm"] == 0
    assert tgemm.GEMM._lib is None


# (M, K, N, mode, scale groups) -> legal for the dequantizing GEMM
SHAPE_ARGS = {
    "single mlp_in, w8": ((4608, 3072, 12288, "w8", 1), True),
    "single out, w4 g128": ((4608, 15360, 3072, "w4", 120), True),
    "x_embedder, w4 one group": ((4096, 64, 3072, "w4", 1), True),
    "adaLN rows, w4 g64": ((4, 3072, 18432, "w4", 48), True),
    "one row, w8": ((1, 256, 3072, "w8", 1), True),
    "K % 64": ((8, 96, 64, "w8", 1), False),
    "N % 8": ((8, 128, 60, "w8", 1), False),
    "no rows": ((0, 128, 64, "w8", 1), False),
    "w4 group % 16": ((8, 192, 64, "w4", 16), False),
    "w4 groups of 8": ((8, 128, 64, "w4", 16), False),
    "w4 groups do not split K": ((8, 192, 64, "w4", 5), False),
    "another mode": ((8, 128, 64, "w4a8", 1), False),
}


@pytest.mark.parametrize("case", list(SHAPE_ARGS))
def test_dequant_gemm_shapes(case):
    args, legal = SHAPE_ARGS[case]
    if legal:
        t4.check_dequant_gemm_shapes(*args)
    else:
        with pytest.raises(ValueError, match="unsupported"):
            t4.check_dequant_gemm_shapes(*args)


# (x strides, codes strides, x address, codes address) -> legal
LAYOUT_ARGS = {
    "contiguous": (((3072, 1), (1536, 1), 0, 256), True),
    "x rows 8 apart": (((8, 1), (16, 1), 16, 0), True),
    "x column stride": (((3072, 2), (1536, 1), 0, 0), False),
    "x rows % 16 bytes": (((3076, 1), (1536, 1), 0, 0), False),
    "codes rows % 16": (((3072, 1), (1544, 1), 0, 0), False),
    "x start % 16": (((3072, 1), (1536, 1), 8, 0), False),
    "codes start % 16": (((3072, 1), (1536, 1), 0, 4), False),
}


@pytest.mark.parametrize("case", list(LAYOUT_ARGS))
def test_dequant_gemm_layout(case):
    args, legal = LAYOUT_ARGS[case]
    if legal:
        t4.check_dequant_gemm_layout(*args)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            t4.check_dequant_gemm_layout(*args)


def test_dequant_linear_refuses_what_the_kernel_does_not_take():
    """A tensor that is on neither the CPU nor a card is refused (the
    kernel route is the card's, with no fallback); under autograd the
    wrapper raises off the plain route: the kernel has no backward."""
    x = torch.empty((4, 128), dtype=torch.bfloat16, device="meta")
    codes = torch.empty((16, 128), dtype=torch.int8, device="meta")
    scale = torch.empty((16,), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        t4.dequant_linear(x, codes, scale)
    xg = torch.zeros((4, 128), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        t4.dequant_linear(xg, torch.zeros((16, 128), dtype=torch.int8),
                          torch.ones(16))
    y = t4.dequant_linear(xg, torch.zeros((16, 128), dtype=torch.int8),
                          torch.ones(16), impl="plain")
    assert y.requires_grad


# ------------------------------------------------------ the w4 pre-scale

def _w4_layer(dtype=torch.float32):
    lin = torch.nn.Linear(128, 24, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((24, 128),
                                     generator=torch.Generator()
                                     .manual_seed(0)) / 12)
    return lin, tq.QuantLinear.from_linear(lin, "w4", group=64)


def test_identity_pre_scale_is_skipped_exactly():
    """A layer quantized without AWQ knows its pre-scale is ones and skips
    the multiply: its output is bit for bit the output with the multiply
    (x * 1 is x); a pre-scale written behind the layer's back is not read
    in ``forward`` (no check on the values there)."""
    _, layer = _w4_layer(torch.bfloat16)
    assert layer.pre_scale_ones
    x = torch.randn((3, 128), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    skipped = layer(x)
    layer.pre_scale_ones = False
    assert torch.equal(layer(x), skipped)
    layer.pre_scale_ones = True
    with torch.no_grad():
        layer.pre_scale.fill_(2.0)
    assert torch.equal(layer(x), skipped)
    layer.note_pre_scale_()
    assert not layer.pre_scale_ones
    assert not torch.equal(layer(x), skipped)


def test_awq_pre_scale_keeps_the_multiply():
    """A JAX tree with an AWQ pre-scale, through the bridge: the layer
    multiplies, and matches QuantDense's AWQ product."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((128, 24)).astype(np.float32) / 12
    amax = np.abs(rng.standard_normal(128)) * 10.0 ** rng.uniform(-1, 1, 128)
    pk, sc, ps = jq.quantize_kernel_w4_awq(k, amax, n_grid=4)
    leaves = {"pkernel": np.asarray(pk), "scale": np.asarray(sc),
              "pre_scale": np.asarray(ps)}
    layer = tq.QuantLinear(128, 24, bias=False, mode="w4")
    load_flax(torch.nn.ModuleDict({"d": layer}), {"d": leaves})
    assert not layer.pre_scale_ones
    x = rng.standard_normal((4, 128)).astype(np.float32)
    dense = jq.QuantDense(24, use_bias=False, mode="w4")
    want = n(dense.apply({"params": leaves}, jnp.asarray(x)))
    got = n(layer(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


def test_load_state_dict_sets_the_pre_scale_flag():
    """``load_state_dict`` of a non-identity pre-scale turns the multiply
    back on, and of ones off again, in the layer and inside a model;
    ``set_weight_`` and ``quantize_module_`` give ones."""
    lin, layer = _w4_layer()
    state = {k: v.clone() for k, v in layer.state_dict().items()}
    state["pre_scale"] = torch.linspace(0.5, 2.0, 128)
    layer.load_state_dict(state)
    assert not layer.pre_scale_ones
    x = torch.randn((2, 128), generator=torch.Generator().manual_seed(2))
    want = torch.nn.functional.linear(
        x * state["pre_scale"], layer.dequantized_weight()
        / state["pre_scale"][None, :]) + layer.bias
    torch.testing.assert_close(layer(x), want, rtol=1e-5, atol=1e-5)
    state["pre_scale"] = torch.ones(128)
    model = torch.nn.Sequential(layer)
    model.load_state_dict({"0." + k: v for k, v in state.items()})
    assert layer.pre_scale_ones
    layer.load_state_dict({**state, "pre_scale": torch.full((128,), 3.0)})
    assert not layer.pre_scale_ones
    layer.set_weight_(lin.weight)
    assert layer.pre_scale_ones
    swapped = tq.quantize_module_(torch.nn.Sequential(lin), "w4")[0]
    assert swapped.pre_scale_ones


def test_converter_plans_and_broadcasts_note_the_pre_scale():
    """Writers that fill a layer's buffers in place past its hooks (a
    converter's plan, a broadcast from rank 0) leave the flag as the
    values say: ``fill_module`` notes it itself, ``note_pre_scales_``
    after a raw copy."""
    from x2i_torch.convert.torch_models import fill_module
    _, layer = _w4_layer()
    model = torch.nn.Sequential(layer)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["0.pre_scale"] = torch.linspace(0.5, 2.0, 128)
    fill_module(model, state.items(), {k: (k, None) for k in state})
    assert not layer.pre_scale_ones
    with torch.no_grad():
        layer.pre_scale.fill_(1.0)
    assert tq.note_pre_scales_(model) is model and layer.pre_scale_ones
