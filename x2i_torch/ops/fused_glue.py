"""Row-local glue kernels of the DiT (K5, K6, K7 and K8, CUDA C++ in
``csrc/row_glue.cu``), their plain PyTorch versions, and the wrappers that
pick between them.

Counterparts of the TPU kernels of ``x2i_tpu/ops/fused_glue.py``, all
launched there through ``_rows_call``:

* K5 ``ln_mod`` (``_ln_mod_kernel``): ``modulate(layer_norm(x), shift,
  scale)`` in x.dtype, the glue of the bf16, w8 and w4 paths;
* K6 ``ln_mod_quant`` (``_ln_mod_quant_kernel``): the same, then per-row
  int8 quantization;
* K7 ``gelu_quant`` (``_gelu_quant_kernel``): tanh-gelu rounded to x.dtype,
  then per-row int8 quantization;
* K8 ``quant_rows`` (``_quant_kernel``): per-row int8 quantization;
  and its two halves for a row split over the members of a tensor axis
  (the row-split layers of the sharded DiT, ``parallel/tensor.py``, where
  XLA quantizes JAX's whole row over sharded features): ``row_absmax``,
  the row's max|x| (f32), and ``quant_rows_at``, the quantization at a
  given absmax (the members' ``pmax``). At the whole row's absmax a
  member's codes and scale are the whole row's K8 bits.

K5-K8 take bf16 rows and f32 rows (an f32 DiT's glue, each f32 instance
counted as its name with ``_f32``: ``ln_mod_f32``, ``ln_mod_quant_f32``,
``gelu_quant_f32``, ``quant_rows_f32``); K8's halves take bf16 rows.

The LayerNorm has f32 row statistics (eps 1e-6, no affine) and rounds the
normalized row to x.dtype before ``* (1 + scale) + shift``, the rounding
point of the unfused path, whose ``layer_norm`` returns the input dtype.
The quantization is the w8a8 mode's dynamic one
(``x2i_tpu/ops/quant.py:39-42``)::

    a_scale = max(max|row|, 1e-6) / 127        (f32, IEEE division)
    codes   = clip(round_half_even(row / a_scale), -127, 127)  (int8)

and returns ``(codes (..., D) int8, a_scale (..., 1) f32)``, the
pre-quantized input form of ``QuantLinear``.

What bounds them on an H100: each reads a bf16 row block once and writes
it once (bf16, or int8 plus a scale per row) against a few operations per
byte, so memory bandwidth does: at 4608 rows about 17 us for K5, 13 us
for K6 and K8 at D = 3072, 51 us for K7 at D = 12288 (3.35 TB/s). On
f32 rows they read twice the bytes: 34 us for K5, 21 us for K8, 85 us
for K7.

The kernels are one library (``ROW_GLUE``; the design is in its header):
persistent blocks walking spans of rows with the next rows' loads in
flight. At D = 3072 K5, K6 and K8 are one warp-per-row body (K6 is K5's
LayerNorm + modulate with the quantization after it, K8 the quantization
alone); K7 and K8 at D = 12288 are two warpgroups per row on a ring of
two rows; other widths (multiples of 8) take a generic instance, for K7
and K8 with the threads per row that ``quant_instance`` chooses from D.
On f32 rows (an f32 DiT's glue) K5-K8 have f32 instances, counted
under their names with ``_f32``: a group of threads a row that
``f32_instance`` chooses. ``row_views``
holds every check they take (bf16 and f32 rows; K8's halves bf16 only);
a wrapper raises ValueError on anything else and never drops to the plain
version. The library is built at its first launch, so a machine without nvcc can
still import this module and run the plain versions.

Every wrapper takes its plain version for a CPU tensor or for
``impl="plain"`` (the plain route of ``FluxConfig.quant_impl``), and
launches its kernel otherwise. The kernels have no backward, as the TPU
ones have none: except on the "plain" route, a wrapper raises when
autograd records and an input requires grad, on the CPU as on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from x2i_torch.ops.cuda_lib import CudaLibrary, refuse_grad

# every glue kernel's launches
LAUNCHES = {"ln_mod": 0, "ln_mod_quant": 0, "gelu_quant": 0,
            "quant_rows": 0, "row_absmax": 0, "quant_rows_at": 0,
            "ln_mod_f32": 0, "ln_mod_quant_f32": 0, "gelu_quant_f32": 0,
            "quant_rows_f32": 0}
# the dtypes a kernel takes where not bf16 alone (K5-K8 also have f32
# instances; K8's halves have none)
ROW_DTYPES = {name: (torch.bfloat16, torch.float32)
              for name in ("ln_mod", "ln_mod_quant", "gelu_quant",
                           "quant_rows")}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _bind(lib):
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.x2i_ln_mod.argtypes = [p, ll, ll, p, p, ll, p, p, i, i, i,
                               ctypes.c_float, p]
    lib.x2i_ln_mod.restype = i
    lib.x2i_quant_rows.argtypes = [p, ll, ll, p, p, i, i, i, i, i, i, i, p,
                                   p]
    lib.x2i_quant_rows.restype = i
    lib.x2i_rows_f32.argtypes = [i, p, ll, ll, p, p, ll, p, p, i, i, i,
                                 ctypes.c_float, i, i, p]
    lib.x2i_rows_f32.restype = i


# K5's f32 instances (f32_rows_kernel<kLnMod, C>, mangled <0, C>), gated
# by name beside the kernel's other instances
F32_K5_INSTANCES = "f32_rows_kernelILi0E"
# K5-K8; their launches count in LAUNCHES. The build gate checks every
# kernel of the library for spills.
ROW_GLUE = CudaLibrary(
    "row_glue.cu", "libx2i_row_glue", (), _bind,
    checked_kernels=("ln_mod_kernel", "ln_mod_quant_kernel",
                     "quant_warp_kernel", "ln_mod_rows_kernel",
                     "quant_ring_kernel", "quant_rows_kernel",
                     "row_amax_warp_kernel", "quant_at_warp_kernel",
                     "f32_rows_kernel", F32_K5_INSTANCES))

# the instances of K7 and K8 (``x2i_quant_rows``'s `kind`)
QUANT_KINDS = {"generic": 0, "warp": 1, "ring": 2}
# what K8 computes (``x2i_quant_rows``'s `op`): the codes and scales, the
# row absmax alone, the codes and scales at a given absmax
QUANT_OPS = {"quant_rows": 0, "row_absmax": 1, "quant_rows_at": 2}
# the kernels on f32 rows (``x2i_rows_f32``'s `op`)
F32_OPS = {"ln_mod": 0, "ln_mod_quant": 1, "quant_rows": 2, "gelu_quant": 3}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ------------------------------------------------------------------ plain

def ln_mod_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x (B, S, D); shift/scale (B, D) -> x.dtype, step by step."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    y = (xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
         ).to(x.dtype)
    return y * (1.0 + scale[:, None, :]) + shift[:, None, :]


def quant_rows_plain(x: torch.Tensor):
    """Per-row int8 quantization of (..., D) -> (int8 (..., D), f32
    (..., 1)), bit for bit the dynamic quantization of the JAX
    ``w8a8_matmul``."""
    return quant_rows_at_plain(x, row_absmax_plain(x))


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """max|x| of each row of (..., D) -> f32 (..., 1)."""
    return x.float().abs().amax(-1, keepdim=True)


def quant_rows_at_plain(x: torch.Tensor, amax: torch.Tensor):
    """``quant_rows_plain`` at the given row absmax ``amax`` (..., 1) f32
    (a whole row's, where x holds a block of its features): a_scale =
    max(amax, 1e-6) / 127, then the codes of x."""
    amax = amax.float().clamp_min(1e-6)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient (the
    # divisor is filled on the device: a copy from the host would block)
    a_scale = amax / amax.new_full((), 127.0)
    q = torch.round(x.float() / a_scale).clamp(-127.0, 127.0) \
        .to(torch.int8)
    return q, a_scale


def ln_mod_quant_plain(x, shift, scale, eps: float = 1e-6):
    return quant_rows_plain(ln_mod_plain(x, shift, scale, eps))


def gelu_quant_plain(x: torch.Tensor):
    """tanh-gelu in f32, rounded to x.dtype (the unfused gelu's output),
    then quantized."""
    return quant_rows_plain(F.gelu(x.float(), approximate="tanh")
                            .to(x.dtype))


# ------------------------------------------------------------------ CUDA

def _rows3(name, x):
    """(B, S, D) or (N, D) in a dtype of the kernel's (``ROW_DTYPES``, by
    default bf16) with a contiguous last dim -> (B, S, D)."""
    dtypes = ROW_DTYPES.get(name, (torch.bfloat16,))
    if x.dtype not in dtypes or x.dim() not in (2, 3) or x.stride(-1) != 1:
        kinds = " or ".join(_DTYPE_NAMES[t] for t in dtypes)
        raise ValueError(f"{name} kernel: x must be (B, S, D) or (N, D) "
                         f"{kinds} with a contiguous last dim, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    return x if x.dim() == 3 else x[None]


def _extras(name, x, shift, scale):
    b, _, d = x.shape
    for label, t in (("shift", shift), ("scale", scale)):
        if (t.dtype != x.dtype or t.shape != (b, d) or t.stride(1) != 1
                or t.device != x.device):
            raise ValueError(f"{name} kernel: {label} must be ({b}, {d}) "
                             f"{x.dtype} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if shift.stride(0) != scale.stride(0):
        shift, scale = shift.contiguous(), scale.contiguous()
    return shift, scale


def check_row_args(name: str, d: int, rows: int, strides, ptrs,
                   itemsize: int = 2):
    """The widths and layouts that the row glue kernels take: at least one
    row, D a multiple of the elements in 16 bytes (8 of bf16, 4 of f32),
    and every row of x (and of shift and scale) starting on a 16-byte
    boundary: each of ``ptrs`` 16-byte aligned and each stride of
    ``strides``, given as (size, stride in elements) of a dim, a multiple
    of the same where the dim's size is above 1. Raises ValueError
    otherwise."""
    per16 = 16 // itemsize
    if rows < 1 or d < per16 or d % per16:
        raise ValueError(f"{name} kernel: unsupported shape: {rows} rows of "
                         f"D = {d} (D must be a multiple of {per16})")
    if (any(size > 1 and stride % per16 for size, stride in strides)
            or any(p % 16 for p in ptrs)):
        raise ValueError(f"{name} kernel: rows must start on 16-byte "
                         f"boundaries, got (size, stride) {list(strides)} "
                         f"and addresses {[p % 16 for p in ptrs]} mod 16")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def quant_instance(d: int, gelu: bool = False, op: str = "quant_rows"):
    """The instance of ``csrc/row_glue.cu`` that quantizes rows of width d
    (K7 with ``gelu``, K8 without; ``op`` K8 or one of its halves, a key of
    ``QUANT_OPS``) and its threads per row: the ring kernel at 12288 (two
    warpgroups a row; K8 alone), K6's warp body without the LayerNorm for
    K8 at 3072, else the generic kernel at one 16-byte chunk (8 values) a
    thread, up to a block of 256 a row (8 threads, four rows a warp, at
    D = 64; a block at 4096). -> (kind, lanes), kind a key of
    ``QUANT_KINDS``."""
    if d == 12288 and op == "quant_rows":
        return "ring", 256
    if d == 3072 and not gelu:
        return "warp", 32
    return "generic", min(256, 1 << max(0, d // 8 - 1).bit_length())


def row_views(name: str, x, shift=None, scale=None):
    """Every check of the row glue kernels: x (B, S, D) or (N, D) bf16
    (for K5-K8 also f32) with a contiguous last dim, shift and scale (B, D)
    of its dtype on its device, then ``check_row_args`` (D % 8, or % 4 in
    f32, 16-byte row starts). Raises ValueError on anything else. -> (x as (B, S, D), shift, scale), the
    modulation rows made contiguous where their strides differ."""
    x = _rows3(name, x)
    b, s, d = x.shape
    strides, ptrs = [(b, x.stride(0)), (s, x.stride(1))], [x.data_ptr()]
    if shift is not None:
        shift, scale = _extras(name, x, shift, scale)
        strides.append((b, shift.stride(0)))
        ptrs += [shift.data_ptr(), scale.data_ptr()]
    check_row_args(name, d, b * s, strides, ptrs, x.element_size())
    return x, shift, scale


def _quant_out(shape, device):
    return (torch.empty(shape, dtype=torch.int8, device=device),
            torch.empty((*shape[:-1], 1), dtype=torch.float32,
                        device=device))


def f32_instance(d: int):
    """The instance of ``csrc/row_glue.cu``'s f32_rows_kernel that runs
    K5-K8 on f32 rows of width d: a group of threads a row, one 16-byte
    chunk a thread up to a block of 256 a row (16 threads at D = 64), then
    4 or 16 chunks a thread held in registers (past 16, read again from
    memory). The same for every op: K5's order of sums is K6's, so that K6
    is bit for bit K8 after K5. -> (lanes, chunks)."""
    quads = d // 4
    lanes = min(256, 1 << max(0, quads - 1).bit_length())
    return lanes, 4 if quads <= 4 * lanes else 16


def _launch_f32(name, x, shift=None, scale=None, eps=1e-6, instance=None):
    """K5 (-> f32 (B, S, D)), K6, K7 or K8 (-> int8 codes of x's shape,
    f32 row scales (..., 1)) on f32 x (B, S, D) or (N, D), counted as
    ``name`` + "_f32", on ``instance`` (lanes, chunks) or the one
    ``f32_instance`` chooses."""
    shape = x.shape
    x, shift, scale = row_views(name, x, shift, scale)
    b, s, d = x.shape
    if name == "ln_mod":
        out, a = torch.empty((b, s, d), dtype=x.dtype, device=x.device), None
    else:
        out, a = _quant_out(shape, x.device)
    lanes, chunks = instance or f32_instance(d)
    modulated = shift is not None
    _check_launch(f"{name}_f32", ROW_GLUE.lib().x2i_rows_f32(
        F32_OPS[name], x.data_ptr(), x.stride(0), x.stride(1),
        shift.data_ptr() if modulated else None,
        scale.data_ptr() if modulated else None,
        shift.stride(0) if modulated else 0, out.data_ptr(),
        None if a is None else a.data_ptr(), b, s, d, eps, lanes, chunks,
        _stream(x)))
    LAUNCHES[f"{name}_f32"] += 1
    return out if a is None else (out, a)


def _launch_ln(name, x, shift, scale, eps, quant):
    if x.dtype == torch.float32:
        return _launch_f32(name, x, shift, scale, eps)
    shape = x.shape
    x, shift, scale = row_views(name, x, shift, scale)
    b, s, d = x.shape
    if quant:
        out, a = _quant_out(shape, x.device)
    else:
        out, a = torch.empty((b, s, d), dtype=x.dtype, device=x.device), None
    _check_launch(name, ROW_GLUE.lib().x2i_ln_mod(
        x.data_ptr(), x.stride(0), x.stride(1), shift.data_ptr(),
        scale.data_ptr(), shift.stride(0), out.data_ptr(),
        None if a is None else a.data_ptr(), b, s, d, eps, _stream(x)))
    LAUNCHES[name] += 1
    return (out, a) if quant else out


def _ln_mod_cuda(x, shift, scale, eps):
    return _launch_ln("ln_mod", x, shift, scale, eps, False)


def _ln_mod_quant_cuda(x, shift, scale, eps):
    return _launch_ln("ln_mod_quant", x, shift, scale, eps, True)


def check_amax(amax, shape, device):
    """The given absmax of ``quant_rows_at``: f32, one contiguous value a
    row of x (shape ``shape``), on x's device. Raises ValueError
    otherwise."""
    if (amax.dtype != torch.float32 or amax.device != device
            or tuple(amax.shape) != (*shape[:-1], 1)
            or not amax.is_contiguous()):
        raise ValueError(f"quant_rows_at kernel: amax must be a contiguous "
                         f"f32 {(*shape[:-1], 1)} on {device}, got "
                         f"{amax.dtype} {tuple(amax.shape)} on "
                         f"{amax.device}")


def _quant_cuda(name, x, gelu: bool, instance=None, amax=None):
    """Launch K7 (``gelu``), K8 or one of K8's halves (``name`` a key of
    ``QUANT_OPS``; ``amax`` the given absmax of "quant_rows_at") over
    (B, S, D) or (N, D) x -> (int8 codes of x's shape, f32 row scales
    (..., 1)), or the f32 row absmax (..., 1) alone for "row_absmax", on
    ``instance`` (kind, lanes) or the one ``quant_instance`` chooses."""
    if x.dtype == torch.float32 and name in F32_OPS:
        return _launch_f32("gelu_quant" if gelu else name, x,
                           instance=instance)
    shape = x.shape
    x = row_views(name, x)[0]
    b, s, d = x.shape
    op = "quant_rows" if gelu else name
    kind, lanes = instance or quant_instance(d, gelu, op)
    if name == "row_absmax":
        q = None
        a = torch.empty((*shape[:-1], 1), dtype=torch.float32,
                        device=x.device)
    else:
        q, a = _quant_out(shape, x.device)
    if amax is not None:
        check_amax(amax, shape, x.device)
    _check_launch(name, ROW_GLUE.lib().x2i_quant_rows(
        x.data_ptr(), x.stride(0), x.stride(1),
        None if q is None else q.data_ptr(), a.data_ptr(), b, s, d,
        int(gelu), QUANT_KINDS[kind], lanes, QUANT_OPS[op],
        None if amax is None else amax.data_ptr(), _stream(x)))
    LAUNCHES[name] += 1
    return a if q is None else (q, a)


def _gelu_quant_cuda(x):
    return _quant_cuda("gelu_quant", x, True)


def _quant_rows_cuda(x, instance=None):
    return _quant_cuda("quant_rows", x, False, instance)


def _plain(name, impl, *tensors):
    """Whether to take the plain version; off the "plain" route, refuse
    autograd first."""
    if impl == "plain":
        return True
    refuse_grad(f"the {name} kernel", *tensors)
    return tensors[0].device.type == "cpu"


def ln_mod(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
           eps: float = 1e-6) -> torch.Tensor:
    """K5: modulate(layer_norm(x), shift, scale) in one pass, x.dtype out.
    x (B, S, D) bf16 or f32; shift/scale (B, D) of x's dtype. A CUDA
    tensor launches the CUDA kernel (its f32 instance on f32 rows, counted
    as ``ln_mod_f32``; it raises on what it does not take); a CPU tensor
    takes ``ln_mod_plain``."""
    if _plain("ln_mod", "auto", x, shift, scale):
        return ln_mod_plain(x, shift, scale, eps)
    return _ln_mod_cuda(x, shift, scale, eps)


def ln_mod_quant(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6, impl: str = "auto"):
    """K6: quantize(modulate(layer_norm(x), shift, scale)) in one pass.
    x (B, S, D) bf16 or f32 (its f32 instance, ``ln_mod_quant_f32``);
    shift/scale (B, D) -> (int8 (B, S, D), f32 (B, S, 1))."""
    if _plain("ln_mod_quant", impl, x, shift, scale):
        return ln_mod_quant_plain(x, shift, scale, eps)
    return _ln_mod_quant_cuda(x, shift, scale, eps)


def gelu_quant(x: torch.Tensor, impl: str = "auto"):
    """K7: quantize(gelu_tanh(x) rounded to x.dtype) in one pass; x is
    (B, S, D) or (N, D), bf16 or f32 (``gelu_quant_f32``)."""
    if _plain("gelu_quant", impl, x):
        return gelu_quant_plain(x)
    return _gelu_quant_cuda(x)


def quant_rows(x: torch.Tensor, impl: str = "auto"):
    """K8: per-row int8 quantization in one pass; x is (B, S, D) or
    (N, D), bf16 or f32 (``quant_rows_f32``)."""
    if _plain("quant_rows", impl, x):
        return quant_rows_plain(x)
    return _quant_rows_cuda(x)


def row_absmax(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """K8's first half: the f32 absmax (..., 1) of each row of x, (B, S,
    D) or (N, D)."""
    if _plain("row_absmax", impl, x):
        return row_absmax_plain(x)
    return _quant_cuda("row_absmax", x, False)


def quant_rows_at(x: torch.Tensor, amax: torch.Tensor, impl: str = "auto"):
    """K8's second half: x's codes and scales at the given row absmax
    ``amax`` (..., 1) f32 (the whole row's, where x is a block of its
    features), in one pass."""
    if _plain("quant_rows_at", impl, x):
        return quant_rows_at_plain(x, amax)
    return _quant_cuda("quant_rows_at", x, False, amax=amax)
