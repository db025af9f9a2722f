"""The argument checks of the port's CUDA kernel wrappers, on the CPU: the
shapes and layouts that the chunked flash forward K2
(``ops/flash_attention.py``), the int8 GEMM (``ops/int8_gemm.py``), the
w4a8 GEMM and the w4 dequantize kernel (``ops/int4_gemm.py``), the
straight-through backward's int8 and w4a8 dequantize kernels and the
row glue kernels K5-K8 (``ops/fused_glue.py``) take, the width ->
instance choice of K7 and K8, K1's grid instance by shape
(``flash_attention.fwd_instance``), and the shapes of the K2 / K3 variants
tool (``x2i_torch/tools/flash_d256_variants.py``). The checks are plain
functions of shapes, strides and addresses, so they run here without a
card; the kernels themselves are held against their plain versions by the
``cuda`` tests in ``test_torch_kernels.py``.
"""

import pytest
import torch

from x2i_torch.ops import flash_attention as tfa
from x2i_torch.ops import fused_glue as tfg
from x2i_torch.ops import int4_gemm as t4
from x2i_torch.ops import int8_gemm as tgemm
from x2i_torch.tools import flash_d256_variants as d256v

# (q shape, k shape), each legal for K2: Sq and Skv multiples of 64, a last
# tile of 64 rows on either side, GQA, the 2048^2 DiT's and the LM's shapes
K2_LEGAL = {
    "DiT 2048^2": ((1, 24, 16896, 128), (1, 24, 16896, 128)),
    "LM 32k": ((1, 14, 32768, 64), (1, 2, 32768, 64)),
    "sq > skv": ((2, 3, 640, 128), (2, 3, 384, 128)),
    "last kv tile of 64": ((2, 3, 256, 64), (2, 3, 704, 64)),
    "last q tile of 64": ((2, 6, 320, 128), (2, 2, 1152, 128)),
    "one tile of 64": ((1, 1, 64, 64), (1, 1, 64, 64)),
    "head dim 256": ((1, 12, 16896, 256), (1, 12, 16896, 256)),
}


@pytest.mark.parametrize("case", list(K2_LEGAL))
def test_chunked_shapes_taken(case):
    q, k = K2_LEGAL[case]
    assert tfa.check_shapes(q, k, k) == (q[0], q[1], k[1], q[2], k[2], q[3])


K2_ILLEGAL = {
    "sq % 64": ((1, 2, 96, 64), (1, 2, 128, 64), None),
    "skv % 64": ((1, 2, 128, 64), (1, 2, 200, 64), None),
    "head dim 32": ((1, 2, 128, 32), (1, 2, 128, 32), None),
    "head dim 512": ((1, 2, 128, 512), (1, 2, 128, 512), None),
    "hq % hk": ((1, 5, 128, 64), (1, 2, 128, 64), None),
    "k and v differ": ((1, 2, 128, 64), (1, 2, 128, 64), (1, 2, 192, 64)),
    "batch differs": ((2, 2, 128, 64), (1, 2, 128, 64), None),
    "3-d": ((2, 128, 64), (2, 128, 64), None),
    "empty": ((1, 2, 0, 64), (1, 2, 128, 64), None),
}


@pytest.mark.parametrize("case", list(K2_ILLEGAL))
def test_chunked_shapes_refused(case):
    q, k, v = K2_ILLEGAL[case]
    with pytest.raises(ValueError, match="unsupported"):
        tfa.check_shapes(q, k, v or k)


def test_chunked_extra_shapes_must_match_q():
    q = (1, 2, 128, 64)
    assert tfa.check_shapes(q, q, q, [q])[3] == 128
    with pytest.raises(ValueError, match="unsupported"):
        tfa.check_shapes(q, q, q, [(1, 2, 64, 64)])


# (shape, strides, data_ptr) -> legal: the strided (B, S, H, D) views the
# dispatcher passes, a contiguous tensor, a misaligned start or stride
ROWS = {
    "strided view": ((1, 24, 16896, 128), (24 * 16896 * 128, 128, 24 * 128,
                                           1), 4096, True),
    "contiguous": ((2, 3, 640, 64), (3 * 640 * 64, 640 * 64, 64, 1), 256,
                   True),
    "last dim strided": ((1, 2, 128, 64), (16384, 8192, 64, 2), 256, False),
    "row stride % 8": ((1, 2, 128, 64), (16384 + 4, 8196, 68, 1), 256,
                       False),
    "start not 16-byte aligned": ((1, 2, 128, 64), (16384, 8192, 64, 1), 264,
                                  False),
}


@pytest.mark.parametrize("case", list(ROWS))
def test_chunked_row_layout(case):
    shape, strides, ptr, legal = ROWS[case]
    if legal:
        tfa.check_rows("q", shape, strides, ptr)
    else:
        with pytest.raises(ValueError, match="q"):
            tfa.check_rows("q", shape, strides, ptr)


# (M, K, N, weight width, k0) -> legal
GEMM_ARGS = {
    "main shape": ((4608, 3072, 12288, 3072, 0), True),
    "attention chunk": ((4608, 3072, 3072, 15360, 0), True),
    "mlp chunk at koff 3072": ((4608, 12288, 3072, 15360, 3072), True),
    "one row": ((1, 3072, 6144, 3072, 0), True),
    "K 64, N 64": ((4096, 64, 64, 64, 0), True),
    "koff on 16 bytes": ((8, 64, 64, 128, 48), True),
    "K % 64": ((8, 96, 64, 128, 0), False),
    "N % 8": ((8, 128, 60, 128, 0), False),
    "koff % 16": ((8, 64, 64, 128, 8), False),
    "koff past the width": ((8, 128, 64, 192, 128), False),
    "negative koff": ((8, 64, 64, 128, -16), False),
    "no rows": ((0, 64, 64, 64, 0), False),
    "no columns": ((8, 64, 0, 64, 0), False),
}


@pytest.mark.parametrize("case", list(GEMM_ARGS))
def test_gemm_shapes(case):
    args, legal = GEMM_ARGS[case]
    if legal:
        tgemm.check_gemm_shapes(*args)
    else:
        with pytest.raises(ValueError, match="unsupported"):
            tgemm.check_gemm_shapes(*args)


# (x strides, w strides, x ptr, w ptr) -> legal
GEMM_LAYOUTS = {
    "contiguous": (((3072, 1), (15360, 1), 0, 512), True),
    "rows of a wider activation": (((4096, 1), (3072, 1), 16, 32), True),
    "x column-strided": (((1, 4608), (3072, 1), 0, 0), False),
    "w row stride % 16": (((3072, 1), (3080, 1), 0, 0), False),
    "x start % 16": (((3072, 1), (3072, 1), 8, 0), False),
    "w start % 16": (((3072, 1), (3072, 1), 0, 4), False),
}


@pytest.mark.parametrize("case", list(GEMM_LAYOUTS))
def test_gemm_layout(case):
    args, legal = GEMM_LAYOUTS[case]
    if legal:
        tgemm.check_gemm_layout(*args)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            tgemm.check_gemm_layout(*args)


# (M, K, N, inputs, groups, k0) -> legal for the w4a8 GEMM: the twelve
# DiT shapes' kinds and the edges of its packed steps
W4A8_ARGS = {
    "main shape": ((4608, 3072, 12288, 3072, 24, 0), True),
    "attention chunk, low half only": ((4608, 3072, 3072, 15360, 120, 0),
                                       True),
    "mlp chunk across the half": ((4608, 12288, 3072, 15360, 120, 3072),
                                  True),
    "x_embedder, g 32": ((4096, 64, 3072, 64, 2, 0), True),
    "time in_layer, one packed step": ((1, 256, 3072, 256, 2, 0), True),
    "high half only": ((8, 128, 64, 512, 4, 256), True),
    "groups of 48": ((8, 96, 64, 96, 2, 0), True),
    "across the half off 128": ((8, 256, 64, 512, 4, 192), False),
    "odd group count": ((8, 384, 64, 384, 3, 0), False),
    "group % 16": ((8, 80, 64, 80, 10, 0), False),
    "in/2 % 16": ((8, 40, 64, 40, 2, 0), False),
    "K % 16": ((8, 120, 64, 256, 2, 0), False),
    "k0 % 16": ((8, 64, 64, 256, 2, 8), False),
    "past the inputs": ((8, 128, 64, 256, 2, 256), False),
    "N % 8": ((8, 256, 60, 256, 2, 0), False),
    "no rows": ((0, 256, 64, 256, 2, 0), False),
}


@pytest.mark.parametrize("case", list(W4A8_ARGS))
def test_w4a8_gemm_shapes(case):
    args, legal = W4A8_ARGS[case]
    if legal:
        t4.check_w4a8_shapes(*args)
    else:
        with pytest.raises(ValueError, match="unsupported"):
            t4.check_w4a8_shapes(*args)


# (N, in/2, groups, row stride, start address) -> legal for the w4
# dequantize kernel
DEQUANT_ARGS = {
    "3072 -> 12288": ((12288, 1536, 24, 1536, 0), True),
    "x_embedder": ((3072, 32, 1, 32, 256), True),
    "one group per row": ((8, 48, 1, 48, 0), True),
    "in/2 % 16": ((8, 40, 1, 48, 0), False),
    "odd group size": ((8, 48, 32, 48, 0), False),
    "row stride % 16": ((8, 32, 1, 40, 0), False),
    "start % 16": ((8, 32, 1, 32, 8), False),
    "no rows": ((0, 32, 1, 32, 0), False),
}


@pytest.mark.parametrize("case", list(DEQUANT_ARGS))
def test_w4_dequant_args(case):
    args, legal = DEQUANT_ARGS[case]
    if legal:
        t4.check_dequant_args(*args)
    else:
        with pytest.raises(ValueError, match="unsupported"):
            t4.check_dequant_args(*args)


# (N, bytes a row, row stride, start address) -> legal for the
# straight-through backward's dequantize kernels (int8: in bytes a row;
# w4a8: in/2)
GRAD_DEQUANT_ARGS = {
    "3072 -> 12288": ((12288, 3072, 3072, 0), True),
    "12288 -> 3072": ((3072, 12288, 12288, 0), True),
    "x_embedder, w4a8": ((3072, 32, 32, 64), True),
    "width % 8": ((8, 36, 48, 0), False),
    "row stride % 8": ((8, 32, 36, 0), False),
    "start % 8": ((8, 32, 32, 4), False),
    "no rows": ((0, 32, 32, 0), False),
}


@pytest.mark.parametrize("case", list(GRAD_DEQUANT_ARGS))
def test_grad_dequant_args(case):
    args, legal = GRAD_DEQUANT_ARGS[case]
    if legal:
        tgemm.check_dequant_rows(*args, "int8 dequantize kernel")
    else:
        with pytest.raises(ValueError, match="unsupported"):
            tgemm.check_dequant_rows(*args, "int8 dequantize kernel")


# (D, rows, (size, stride) of each dim that walks rows, row start
# addresses) -> legal, for K5 and K7
ROW_ARGS = {
    "K5 main path": ((3072, 4608, [(1, 4608 * 3072), (4608, 3072),
                                   (1, 18432)], [0, 4096, 10240]), True),
    "K7 main path": ((12288, 4608, [(1, 4608 * 12288), (4608, 12288)], [256]),
                     True),
    "batch 2, chunk(6) rows": ((3072, 1024, [(2, 512 * 3072), (512, 3072),
                                             (2, 18432)],
                                [0, 0, 6144]), True),
    "generic width 64": ((64, 1, [(1, 64), (1, 64)], [16]), True),
    "one batch, odd batch stride": ((3072, 4, [(1, 3), (4, 3072)], [0]),
                                    True),
    "D % 8": ((3076, 8, [(1, 8 * 3076), (8, 3076)], [0]), False),
    "D 4": ((4, 8, [(1, 32), (8, 4)], [0]), False),
    "no rows": ((3072, 0, [(1, 0), (0, 3072)], [0]), False),
    "row stride % 8": ((3072, 8, [(1, 8 * 3076), (8, 3076)], [0]), False),
    "modulation batch stride % 8": ((3072, 8, [(2, 4 * 3072), (4, 3072),
                                               (2, 3073)], [0, 0, 0]),
                                    False),
    "start not 16-byte aligned": ((3072, 8, [(1, 8 * 3072), (8, 3072)],
                                   [8]), False),
    "modulation start not aligned": ((3072, 8, [(1, 8 * 3072), (8, 3072),
                                                (1, 18432)], [0, 2, 0]),
                                     False),
}


@pytest.mark.parametrize("case", list(ROW_ARGS))
def test_row_glue_args(case):
    args, legal = ROW_ARGS[case]
    if legal:
        tfg.check_row_args("ln_mod", *args)
    else:
        with pytest.raises(ValueError, match="ln_mod"):
            tfg.check_row_args("ln_mod", *args)


@pytest.mark.parametrize("kernel", ["ln_mod", "ln_mod_quant", "gelu_quant",
                                    "quant_rows"])
def test_row_glue_wrappers_refuse_a_width_not_a_multiple_of_8(kernel):
    """The CUDA wrappers raise ValueError on D % 8 != 0 before they build
    or launch anything (K6's and K8's earlier Triton kernels took any
    D)."""
    x = torch.zeros((1, 4, 12), dtype=torch.bfloat16)
    e = torch.zeros((1, 12), dtype=torch.bfloat16)
    before = tfg.LAUNCHES[kernel]
    with pytest.raises(ValueError, match="multiple of 8"):
        if kernel == "ln_mod":
            tfg._ln_mod_cuda(x, e, e, 1e-6)
        elif kernel == "ln_mod_quant":
            tfg._ln_mod_quant_cuda(x, e, e, 1e-6)
        elif kernel == "gelu_quant":
            tfg._gelu_quant_cuda(x)
        else:
            tfg._quant_rows_cuda(x)
    assert tfg.LAUNCHES[kernel] == before
    assert tfg.ROW_GLUE._lib is None


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _aligned(t):
    """t with its storage's first element on a 16-byte boundary (a CPU
    allocation need not be): a view into a larger buffer."""
    buf = torch.zeros(t.numel() + 8, dtype=t.dtype)
    off = (-buf.data_ptr() // t.element_size()) % 8
    return buf[off:off + t.numel()].view(t.shape)


# case -> (x, shift, scale or None for K8) -> the error's words, or None
# where K6 (with shift and scale) or K8 (without) take it
def _k6_k8_cases():
    x = _aligned(_bf16(2, 5, 64))
    mod = _aligned(_bf16(2, 6 * 64))
    wide = _aligned(_bf16(1, 5, 72))
    odd = _aligned(_bf16(2, 6 * 64 + 4))
    return {
        "K6, chunk(6) rows": ((x, mod[:, :64], mod[:, 64:128]), None),
        "K6, (N, D) x with (1, D) rows": ((x[0], mod[:1, :64],
                                           mod[:1, 64:128]), None),
        "K8, (B, S, D)": ((x,), None),
        "K8, (N, D)": ((x[1],), None),
        "K8, S slice of 16-byte rows": ((x[:, 1:4],), None),
        "K8, D 12": ((_aligned(_bf16(3, 12)),), "multiple of 8"),
        "K8, unaligned x": ((wide[:, :, 4:68],), "16-byte"),
        "K8, row stride % 8": ((_aligned(_bf16(5, 68))[:, :64],),
                               "16-byte"),
        "K8, f32 x": ((_aligned(torch.zeros(4, 64)),), None),
        "K8, f32 D 12": ((_aligned(torch.zeros(3, 12)),), None),
        "K8, f32 D 6": ((_aligned(torch.zeros(3, 6)),), "multiple of 4"),
        "K8, f16 x": ((_aligned(torch.zeros(4, 64, dtype=torch.float16)),),
                      "bf16 or f32"),
        "K6, f32 rows": ((_aligned(torch.zeros(2, 5, 64)),
                          _aligned(torch.zeros(2, 6 * 64))[:, :64],
                          _aligned(torch.zeros(2, 6 * 64))[:, 64:128]),
                         None),
        "K6, f32 x, bf16 rows": ((_aligned(torch.zeros(2, 5, 64)),
                                  mod[:, :64], mod[:, 64:128]),
                                 "shift must be"),
        "K8, last dim strided": ((_aligned(_bf16(64, 4)).t(),), "bf16"),
        "K6, unaligned x": ((wide[:, :, 4:68][:1].expand(2, 5, 64),
                             mod[:, :64], mod[:, 64:128]), "16-byte"),
        "K6, modulation batch stride % 8": ((x, odd[:, :64],
                                             odd[:, 64:128]), "16-byte"),
        "K6, unaligned scale rows": ((x, mod[:, :64], mod[:, 68:132]),
                                     "16-byte"),
        "K6, shift of another shape": ((x, mod[:1, :64], mod[:, 64:128]),
                                       "shift must be"),
        "K6, f32 scale": ((x, mod[:, :64], torch.zeros(2, 64)),
                          "scale must be"),
    }


@pytest.mark.parametrize("case", list(_k6_k8_cases()))
def test_k6_k8_row_views(case):
    """Every check that K6 and K8 take, on CPU tensors: bf16 or f32 rows,
    D % 8 (bf16) or % 4 (f32), x's and the modulation rows' 16-byte
    starts and strides, the modulation rows in x's dtype, (N, D) inputs.
    The wrappers raise these before they build or launch anything, and
    never drop to the plain version."""
    args, error = _k6_k8_cases()[case]
    name = "ln_mod_quant" if len(args) == 3 else "quant_rows"
    if error is None:
        x3, shift, scale = tfg.row_views(name, *args)
        assert x3.dim() == 3 and x3.shape[-1] == args[0].shape[-1]
        assert x3.data_ptr() == args[0].data_ptr()
        if len(args) == 3:
            assert shift.shape == scale.shape == (x3.shape[0], 64)
    else:
        with pytest.raises(ValueError, match=error):
            tfg.row_views(name, *args)
        with pytest.raises(ValueError, match=error):
            if len(args) == 3:
                tfg._ln_mod_quant_cuda(*args, 1e-6)
            else:
                tfg._quant_rows_cuda(*args)
        assert tfg.ROW_GLUE._lib is None


# width -> (K8's instance, K7's): the unfused w8a8 layers' inputs (64, 256,
# 768, 3072, 4096), the MLP width 12288, and the narrowest widths
QUANT_INSTANCES = {
    8: (("generic", 1), ("generic", 1)),
    24: (("generic", 4), ("generic", 4)),
    64: (("generic", 8), ("generic", 8)),
    256: (("generic", 32), ("generic", 32)),
    768: (("generic", 128), ("generic", 128)),
    3072: (("warp", 32), ("generic", 256)),
    4096: (("generic", 256), ("generic", 256)),
    12288: (("ring", 256), ("ring", 256)),
}


@pytest.mark.parametrize("d", list(QUANT_INSTANCES))
def test_quant_instance_follows_the_width(d):
    """K8 at 3072 is K6's warp body without the LayerNorm, at 12288 (with
    K7) the ring kernel; other widths take the generic kernel at one
    16-byte chunk a thread, up to a block of 256 a row: several rows a
    warp below 256 values."""
    k8, k7 = QUANT_INSTANCES[d]
    assert tfg.quant_instance(d) == k8
    assert tfg.quant_instance(d, gelu=True) == k7
    for kind, lanes in (k8, k7):
        assert kind in tfg.QUANT_KINDS
        if kind == "generic":
            # the least power of two of threads that holds the row's chunks
            assert 256 % lanes == 0
            assert lanes == 256 or (lanes * 8 >= d
                                    and (lanes == 1 or lanes * 4 < d))


# width -> the f32 instance of K5-K8, (threads a row, chunks a thread):
# one 16-byte chunk a thread up to a block of 256 a row, then 4 or 16
# chunks a thread in registers
F32_INSTANCES = {
    64: (16, 4),
    256: (64, 4),
    768: (256, 4),
    3072: (256, 4),
    3076: (256, 4),
    4096: (256, 4),
    6144: (256, 16),
    12288: (256, 16),
    16384: (256, 16),
    16388: (256, 16),
}


@pytest.mark.parametrize("d", list(F32_INSTANCES))
def test_f32_instance_follows_the_width(d):
    """K5-K8's f32 instance by width: every width that is a multiple of 4
    has one (no limit), the same for every op (K5's order of sums is K6's:
    K6 is bit for bit K8 after K5)."""
    assert tfg.f32_instance(d) == F32_INSTANCES[d]
    lanes, chunks = F32_INSTANCES[d]
    assert 256 % lanes == 0 and chunks in (4, 16)


@pytest.mark.parametrize("name", ["row_absmax", "quant_rows_at"])
def test_k8_halves_take_bf16_rows_only(name):
    """K8's halves (the sharded DiT's row-split layers) have no f32
    instance: f32 rows are refused before anything is built."""
    x = _aligned(torch.zeros(4, 64))
    with pytest.raises(ValueError, match="bf16 with"):
        tfg.row_views(name, x)
    assert tfg.ROW_GLUE._lib is None


def _epilogue(m, n, dtype, add_dtype=None, bias_dtype=None, ldd=None,
              offset=0):
    """The epilogue's operands on the CPU: a_scale (m, 1), scale (n,), a
    bias (n,) and an addend (m, n) rows ldd apart, ``offset`` elements
    into a 16-byte aligned buffer."""
    ldd = ldd or n
    buf = _aligned(torch.zeros(m * ldd + 8, dtype=add_dtype or dtype))
    addend = buf[offset:offset + m * ldd].view(m, ldd)[:, :n]
    return (torch.ones(m, 1), torch.ones(n),
            torch.zeros(n, dtype=bias_dtype or dtype), addend)


# case -> (epilogue arguments, the error's words or None where taken)
EPILOGUE_CASES = {
    "bf16": (dict(m=8, n=64, dtype=torch.bfloat16), None),
    "f32": (dict(m=8, n=64, dtype=torch.float32), None),
    "f32, addend rows of a wider tensor": (
        dict(m=8, n=64, dtype=torch.float32, ldd=72), None),
    "f16 out": (dict(m=8, n=64, dtype=torch.float16), "bf16 or f32"),
    "f32 out, bf16 bias": (dict(m=8, n=64, dtype=torch.float32,
                                bias_dtype=torch.bfloat16), "bias must be"),
    "f32 out, f16 addend": (dict(m=8, n=64, dtype=torch.float32,
                                 add_dtype=torch.float16), "addend must be"),
    "bf16 out, f32 addend": (dict(m=8, n=64, dtype=torch.bfloat16,
                                  add_dtype=torch.float32), "addend must be"),
    "f32 addend row stride % 4": (
        dict(m=8, n=64, dtype=torch.float32, ldd=66), "16-byte"),
    "f32 addend start % 16": (
        dict(m=8, n=64, dtype=torch.float32, offset=2), "16-byte"),
}


@pytest.mark.parametrize("kernel", ["int8 GEMM kernel", "w4a8 GEMM kernel"])
@pytest.mark.parametrize("case", list(EPILOGUE_CASES))
def test_gemm_epilogue_checks(kernel, case):
    """The int8 and w4a8 GEMMs' epilogue operands (``check_epilogue``), on
    CPU tensors: a bf16 or f32 output, the bias and the addend in its
    dtype, an f32 addend's rows on 16-byte boundaries; f16 is refused."""
    kw, error = EPILOGUE_CASES[case]
    m, n, dtype = kw["m"], kw["n"], kw["dtype"]
    args = _epilogue(**kw)
    if error is None:
        a, d = tgemm.check_epilogue(kernel, m, n, *args, dtype,
                                    torch.device("cpu"))
        assert a.shape == (m,) and d.shape == (m, n)
    else:
        with pytest.raises(ValueError, match=error):
            tgemm.check_epilogue(kernel, m, n, *args, dtype,
                                 torch.device("cpu"))


@pytest.mark.parametrize("dtype,taken", [(torch.bfloat16, True),
                                         (torch.float32, True),
                                         (torch.float16, False)])
def test_dequant_kernels_write_bf16_or_f32(dtype, taken):
    """The int8 and w4 dequantize kernels write a bf16 or an f32 weight;
    f16 is refused (``check_dequant_dtype``)."""
    for kernel in ("int8 dequantize kernel", "w4 dequantize kernel"):
        if taken:
            tgemm.check_dequant_dtype(kernel, dtype)
        else:
            with pytest.raises(ValueError, match="bf16 or f32"):
                tgemm.check_dequant_dtype(kernel, dtype)


# K1's grid instance on an H100's 132 SMs: (batch, q heads, q rows, head
# dim) -> (consumer warpgroups, blocks an SM)
H100_SMS = 132
FWD_INSTANCE_CASES = {
    # the pad route's vision towers at D = 64: 144 and 192 128-row blocks
    # (two waves) as 288 and 384 64-row blocks at three an SM (one wave)
    "InternViT-300M (1,16,1152,64)": ((1, 16, 1152, 64), (1, 3)),
    "CLIP ViT-L/14 (4,16,384,64)": ((4, 16, 384, 64), (1, 3)),
    # MiniCPM-o's resampler: 64-row blocks, one an SM
    "resampler (1,28,128,128)": ((1, 28, 128, 128), (1, 1)),
    "resampler, 2 slices (2,28,128,128)": ((2, 28, 128, 128), (1, 1)),
    # the LM prefills keep their instance
    "LM 0.5B (1,14,512,64)": ((1, 14, 512, 64), (1, 1)),
    "LM 3B / 4B (1,16,512,128)": ((1, 16, 512, 128), (1, 1)),
    "LM 7B (1,28,512,128)": ((1, 28, 512, 128), (2, 1)),
    # the 24 x 128 DiT's 864 blocks
    "DiT 24 x 128 (1,24,4608,128)": ((1, 24, 4608, 128), (2, 1)),
    # D = 128 and 256 at the vision towers' grids keep the 128-row blocks
    "D 128 at InternViT's grid": ((1, 16, 1152, 128), (2, 1)),
    "D 256 at CLIP's grid": ((4, 16, 384, 256), (2, 1)),
    "DiT 12 x 256 (1,12,4608,256)": ((1, 12, 4608, 256), (2, 1)),
    "12 x 256 ring shard (1,12,1152,256)": ((1, 12, 1152, 256), (2, 1)),
    "12 x 256 pad route (1,12,4224,256)": ((1, 12, 4224, 256), (2, 1)),
    # D = 64 past three 64-row blocks an SM: the 128-row blocks
    "D 64, 400 128-row blocks": ((1, 16, 3200, 64), (2, 1)),
    "D 64, one wave of 128-row blocks": ((1, 16, 1024, 64), (2, 1)),
}


@pytest.mark.parametrize("case", list(FWD_INSTANCE_CASES))
def test_fwd_instance(case):
    """K1's grid instance: the rule's choice, an instance the kernel
    library has, and one wave wherever the rule takes 64-row blocks."""
    (b, hq, sq, d), want = FWD_INSTANCE_CASES[case]
    got = tfa.fwd_instance(b, hq, sq, d, H100_SMS)
    assert got == want
    assert (d, *got) in tfa.FWD_INSTANCES
    wgs, per_sm = got
    blocks = b * hq * sq // (64 * wgs)
    if wgs == 1:
        assert blocks <= per_sm * H100_SMS


@pytest.mark.parametrize("label", list(d256v.CASES))
def test_d256_variant_cases_are_kernel_shapes(label):
    """Each case of the K2 / K3 / K4 / K5 variants tool is a shape its
    kernel takes (K2: Sq and Skv multiples of 64; K3 and K4: of 128; K5:
    f32 rows of a width that is a multiple of 4, on the wrapper's instance
    or one it takes), in a dtype the kernels have and with an input the
    tool knows how to make."""
    if d256v.CASES[label][0] == "k5":
        _, b, rows, width, instance = d256v.CASES[label]
        lanes, chunks = instance or tfg.f32_instance(width)
        assert b * rows > 0 and width % 4 == 0
        assert 256 % lanes == 0 and chunks in (4, 16)
        return
    kernel, b, hq, hk, sq, skv, d, dtype, what = d256v.CASES[label]
    check = tfa.check_shapes if kernel == "k2" else tfa.check_kernel_shapes
    k = (b, hk, skv, d)
    assert check((b, hq, sq, d), k, k) == (b, hq, hk, sq, skv, d)
    assert dtype in ("bf16", "f32")
    assert what in {"k2": ("plain", "lse", "lm", "odd"),
                    "k3": ("plain", "rope", "pad", "lm"),
                    "k4": ("plain", "rope", "pad", "lm")}[kernel]


# K4's launches: (B, q heads, kv heads, S, D) -> (splits, whether the
# reduce kernel runs) on an H100's 132 SMs; kv blocks of 64 rows at
# D = 256, 128 below. With rope or without, a launch without a split
# writes dk and dv itself (at D = 256 the warpgroup that keeps dk holds
# each column's rotation partner and counter-rotates it in registers).
DKV_LAUNCHES = {
    "12 x 256 DiT, rope in the kernel": ((1, 12, 12, 4608, 256), (1, False)),
    "12 x 256 ring shard, rope": ((1, 12, 12, 1152, 256), (1, False)),
    "FLUX 24 x 128, rope": ((1, 24, 24, 4608, 128), (1, False)),
    "LM 14 on 2 kv heads x 64": ((1, 14, 2, 512, 64), (14, True)),
    "small grid at D = 256, rope": ((1, 2, 2, 512, 256), (8, True)),
    "small grid at D = 128": ((1, 2, 2, 256, 128), (4, True)),
}


@pytest.mark.parametrize("case", list(DKV_LAUNCHES))
def test_dkv_reduces_with_a_split_alone(case):
    """K4's split (``dkv_splits`` over its blocks) and the reduce kernel
    behind it (``dkv_reduces``): f32 partial sums with a split alone, at
    every head dim, with rope or without."""
    (b, hq, hk, s, d), want = DKV_LAUNCHES[case]
    rows = 64 if d == 256 else 128
    splits = tfa.dkv_splits(s // rows * hk * b, hq // hk * s // 64, H100_SMS)
    assert (splits, tfa.dkv_reduces(splits)) == want
