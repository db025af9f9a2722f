"""Flash attention on the card: the CUDA kernels ``csrc/flash_fwd.cu``
(K1, the forward, with the lse output the backward reads),
``csrc/flash_chunked.cu`` (K2, the online-softmax forward for more than
``MAX_KV_SEQ`` kv tokens) and ``csrc/flash_bwd.cu`` (K3 dq, K4 dk/dv),
their plain PyTorch versions, the plain attention for shapes the kernels
do not take, and the autograd ``Function`` that ties forward and backward
together.

Counterpart of ``x2i_tpu/ops/flash_attention.py``. The TPU forward kernel
``_flash_kernel`` has two bodies, and so do the plain version here and
the CUDA kernel:

* pipelined (no kv mask, not causal, Skv >= 256, no lse -- the TPU rule
  that picks ``pipeline_kc``): softmax as ``exp2(clip(s, -100, 100))``
  with no row max; FLUX joint attention, with the half-layout rope and the
  qk RMSNorm applied inside;
* exact (otherwise, and always when the lse is asked for): kv mask and
  causal mask with the finite ``NEG_INF``, GQA, row-max softmax; the Qwen2
  LM prefill, and every forward that autograd will differentiate. It can
  return the base-2 row logsumexp ``lse = m + log2(l)``, f32 (B, Hq, Sq).

Above ``MAX_KV_SEQ`` kv tokens the forward is K2, the counterpart of
``_flash_chunked_kernel``: an exact online softmax over kv tiles with the
kv mask, the causal mask and its block skip, GQA and the optional lse, and
with no rope or qk norm inside. ``flash_attention`` then applies the
RMSNorm and the rotation first, each rounded to the input dtype, as the
JAX ``flash_attention`` and ``_fwd_impl`` do.

The rounding points are the TPU kernels': with rope, q after norm -> rope
-> ``* scale * log2(e)`` is rounded to the input dtype, rotated K likewise,
and ``p`` is cast to the input dtype before the PV product. The backward
kernels round as ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` do (see
``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain``).

K1 (with and without the lse), K2, K3 and K4 also have f32 instances, for
modules that run in f32 on the card (the CLIP scorer evaluates in f32, an
f32 DiT serves and trains in f32, as in JAX): q, k, v (and do) are
rounded to bf16 on the card and go through the body they would take in
bf16, and o, the lse, dq, dk and dv are written in f32 from the f32
accumulators. Their results are the bf16 bodies' up to the rounding of
the outputs, not the plain versions' f32 products. K1's f32 forward
without the lse takes the rope and the qk norm inside, as the bf16 K1a
does (the rope-and-norm instance: an f32 DiT serving at up to
``MAX_KV_SEQ`` tokens), with the bf16 K1a's rounding points on the
inputs rounded to bf16. The other f32 instances take no rope: a call that
autograd records rotates outside (``flash_attention``), its transpose
carried by autograd; in f32 the TPU kernels' rounding of the rotated q
and k to the input dtype is the identity, so that is JAX's f32 function.
Every other dtype takes the plain attention (``attention.route``).

Head dims: every instance, forward and backward, bf16 and f32, takes
``HEAD_DIMS`` (64, 128 and 256), the TPU kernels' ``supported``.

K1's grid instance, the q rows of a block and the blocks an SM holds, is
chosen here from the shapes and the card's SM count (``fwd_instance``)
and handed to the library with each bf16 launch.

Rope tables are ``(S, D)`` f32 as ``flux_rope_freqs_half`` makes them,
cos = cat(c, c) and sin = cat(s, s); only their first halves are read, as
``apply_rope_half`` reads them.

``flash_attention`` is differentiable: when autograd records (grad mode on
and an input requiring grad) it runs ``_FlashAttention``, whose forward is
K1 with the lse (K2 with the lse above ``MAX_KV_SEQ``) and whose backward
is K3 and K4 (above ``MAX_KV_SEQ`` a recompute through the plain
attention), the counterpart of the JAX ``custom_vjp`` ``_flash``. With
``qk_norm`` inside the kernel it is forward-only, as in JAX, and raises
under grad. Each wrapper launches its kernel for a CUDA
tensor and takes its plain version for a CPU tensor; there is no other
fallback. The kernels are built from the repository's sources with
``nvcc`` at first use, into ``x2i_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from x2i_torch.ops.cuda_lib import CudaLibrary, refuse_grad
from x2i_torch.ops.norms import rms_norm

NEG_INF = -1e30
LOG2_E = math.log2(math.e)
HEAD_DIMS = (64, 128, 256)        # every instance
# the JAX package's limits: above MAX_KV_SEQ kv tokens the forward is the
# chunked kernel K2 (norm and rope outside) and the backward recomputes
# through the plain attention; above ROPE_MAX_KV the differentiable route
# applies the rope outside the kernels. Both are read at call time.
MAX_KV_SEQ = 8192
ROPE_MAX_KV = 6144


def supported(q_shape, kv_seq: int) -> bool:
    """Whether the forward kernels apply to these shapes: the TPU rule
    (``supported``, S % 128 == 0, D in 64, 128 and 256), forward and
    backward."""
    _, _, sq, d = q_shape
    return d in HEAD_DIMS and kv_seq % 128 == 0 and sq % 128 == 0


def is_exact(kv_mask, causal: bool, skv: int) -> bool:
    """The TPU kernel's choice of body without the lse: the pipelined one
    needs no mask, no causal mask and at least two 128-row kv chunks."""
    return kv_mask is not None or causal or skv < 256


def _norm_rows(x: torch.Tensor, w: Optional[torch.Tensor], eps: float):
    """f32 RMSNorm of (B, H, S, D) rows with a (D,) or per-row (S, D)
    scale, as the kernel takes them (per-row tables in bf16)."""
    if w is None:
        return x
    w = w.to(torch.bfloat16).float() if w.dim() == 2 else w.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half-layout rotation of f32 (B, H, S, D) rows with (S, D) tables."""
    d2 = x.shape[-1] // 2
    c, s = cos[:, :d2].float(), sin[:, :d2].float()
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rotate_t(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """The transpose (= inverse) of ``_rotate``, for cotangents: the TPU
    kernels' ``_counter_rotate``."""
    d2 = g.shape[-1] // 2
    c, s = cos[:, :d2].float(), sin[:, :d2].float()
    g1, g2 = g[..., :d2], g[..., d2:]
    return torch.cat([g1 * c + g2 * s, g2 * c - g1 * s], dim=-1)


def rope_bhsd(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """The rotation applied outside the kernels ((B, H, S, D), f32, x.dtype
    out), differentiable: the JAX ``_rope_bhsd``."""
    return _rotate(x.float(), cos, sin).to(x.dtype)


def _mask_scores(s, kv_mask, causal, causal_offset=0):
    """Masked scores: keys off ``kv_mask`` and, with ``causal``, keys
    after query row r's diagonal at column ``causal_offset + r``."""
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    if causal:
        sq, skv = s.shape[-2:]
        rows = causal_offset + torch.arange(sq, device=s.device)[:, None]
        cols = torch.arange(skv, device=s.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def _repeat_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    return t.repeat_interleave(group, dim=1)


def flash_attention_plain(q, k, v, kv_mask=None, causal=False, scale=None,
                          rope=None, qk_norm=None, return_lse=False):
    """The kernel's function step by step in PyTorch: (B, Hq, Sq, D) q,
    (B, Hk, Skv, D) k/v, (B, Skv) bool kv_mask -> (B, Hq, Sq, D) in
    q.dtype, and with ``return_lse`` also the f32 (B, Hq, Sq) base-2 lse
    (the exact body)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    post = scale * LOG2_E
    group = q.shape[1] // k.shape[1]
    if rope is not None:
        cos, sin = rope
        qw, kw, eps = qk_norm if qk_norm is not None else (None, None, 1e-6)
        qr = (_rotate(_norm_rows(q.float(), qw, eps), cos, sin) * post
              ).to(q.dtype)
        kr = _rotate(_norm_rows(k.float(), kw, eps), cos, sin).to(k.dtype)
        s = qr.float() @ _repeat_kv(kr, group).float().transpose(-1, -2)
    else:
        kf = _repeat_kv(k, group).float()
        s = (q.float() @ kf.transpose(-1, -2)) * post
    vf = _repeat_kv(v, group)
    lse = None
    if return_lse or is_exact(kv_mask, causal, k.shape[2]):
        s = _mask_scores(s, kv_mask, causal)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        if return_lse:
            lse = (m + torch.log2(p.sum(-1, keepdim=True)))[..., 0
                                                           ].contiguous()
    else:
        p = torch.exp2(s.clamp(-100.0, 100.0))
    o = ((p.to(v.dtype).float() @ vf.float()) / p.sum(-1, keepdim=True)
         ).to(q.dtype)
    return (o, lse) if return_lse else o


def flash_forward_chunked_plain(q, k, v, kv_mask=None, causal=False,
                                scale=None, return_lse=False,
                                block_q: int = 256, block_k: int = 512,
                                causal_skip: bool = True):
    """K2 step by step, tile by tile as ``_flash_chunked_kernel`` walks
    its grid: f32 scores of a (block_q, block_k) tile times scale *
    log2(e), the kv and causal masks with the finite ``NEG_INF``, the
    running max m (from ``NEG_INF``) and sum l, p rounded to v.dtype
    before the PV product, o = acc / l in q.dtype and, with
    ``return_lse``, the f32 (B, Hq, Sq) base-2 lse = m + log2(l). Under
    the causal mask a kv tile that starts above the q tile's last row is
    skipped (``causal_skip``), as in the TPU kernel. Sq != Skv is legal;
    the causal diagonal is aligned at row 0.

    A row with no valid key (left padding under the causal mask) gives
    the mean of v over the keys of the tiles it visited, which depends on
    the tile sizes and on the skip, here as in JAX: compare such rows with
    nothing."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    post = scale * LOG2_E
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    group = hq // k.shape[1]
    block_q, block_k = min(block_q, sq), min(block_k, skv)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    for i0 in range(0, sq, block_q):
        qi = q[:, :, i0:i0 + block_q].float()
        nq = qi.shape[2]
        rows = torch.arange(i0, i0 + nq, device=q.device)[:, None]
        m = torch.full((b, hq, nq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hq, nq, d), dtype=torch.float32,
                          device=q.device)
        for j0 in range(0, skv, block_k):
            if causal and causal_skip and j0 >= i0 + block_q:
                break
            kj = _repeat_kv(k[:, :, j0:j0 + block_k], group)
            vj = _repeat_kv(v[:, :, j0:j0 + block_k], group)
            s = (qi @ kj.float().transpose(-1, -2)) * post
            if kv_mask is not None:
                s = s.masked_fill(
                    ~kv_mask[:, None, None, j0:j0 + block_k], NEG_INF)
            if causal:
                cols = torch.arange(j0, j0 + kj.shape[2],
                                    device=q.device)[None, :]
                s = s.masked_fill(cols > rows, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ vj.float()
            m = m_new
        out[:, :, i0:i0 + nq] = (acc / l).to(q.dtype)
        lse[:, :, i0:i0 + nq] = (m + torch.log2(l))[..., 0]
    return (out, lse) if return_lse else out


def _delta(o, do):
    """sum(do * o) per row in f32, (B, Hq, Sq): computed outside the
    kernels, as in JAX."""
    return (do.float() * o.float()).sum(-1).contiguous()


def flash_bwd_dq_plain(q, k, v, do, lse, delta, kv_mask=None, causal=False,
                       scale=None, rope=None):
    """K3 step by step: dq (B, Hq, Sq, D) in q.dtype. With rope, q is
    rotated, scaled by scale * log2(e) and rounded, k rotated and rounded
    (the forward's recipe), and dq is counter-rotated."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    post = scale * LOG2_E
    group = q.shape[1] // k.shape[1]
    if rope is not None:
        cos, sin = rope
        qs = (_rotate(q.float(), cos, sin) * post).to(q.dtype)
        kr = _repeat_kv(_rotate(k.float(), cos, sin).to(k.dtype), group)
        s = qs.float() @ kr.float().transpose(-1, -2)
    else:
        kr = _repeat_kv(k, group)
        s = (q.float() @ kr.float().transpose(-1, -2)) * post
    p = torch.exp2(_mask_scores(s, kv_mask, causal) - lse[..., None])
    dp = do.to(v.dtype).float() @ _repeat_kv(v, group).float().transpose(
        -1, -2)
    ds = p * (dp - delta[..., None]) * scale
    dq = ds.to(k.dtype).float() @ kr.float()
    if rope is not None:
        dq = _rotate_t(dq, *rope)
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, kv_mask=None, causal=False,
                        scale=None, rope=None):
    """K4 step by step: (dk, dv), each (B, Hk, Skv, D), the GQA group summed
    in f32. With rope, q and k are rotated and rounded WITHOUT the scale,
    which multiplies the f32 scores instead, and dk is counter-rotated."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    group = hq // hk
    if rope is not None:
        qr = _rotate(q.float(), *rope).to(q.dtype)
        kr = _rotate(k.float(), *rope).to(k.dtype)
    else:
        qr, kr = q, k
    s = (qr.float() @ _repeat_kv(kr, group).float().transpose(-1, -2)
         ) * (scale * LOG2_E)
    p = torch.exp2(_mask_scores(s, kv_mask, causal) - lse[..., None])
    dof = do.to(v.dtype).float()
    dp = dof @ _repeat_kv(v, group).float().transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale

    def group_sum(a, x):          # (B, Hq, Sq, Skv), (B, Hq, Sq, D)
        return torch.einsum("bhgqk,bhgqd->bhkd",
                            a.view(b, hk, group, sq, skv),
                            x.view(b, hk, group, sq, d))

    dv = group_sum(p.to(do.dtype).float(), dof)
    dk = group_sum(ds.to(q.dtype).float(), qr.float())
    if rope is not None:
        dk = _rotate_t(dk, *rope)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, kv_mask, o, lse, do, causal=False,
                         scale=None, rope=None):
    """K3 and K4's plain versions: (dq, dk, dv)."""
    delta = _delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, kv_mask, causal, scale,
                            rope)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, lse, delta, kv_mask,
                                     causal, scale, rope))


def xla_attention(q, k, v, kv_mask=None, causal=False, scale=None,
                  bias=None, causal_offset=0) -> torch.Tensor:
    """Plain f32 softmax attention over (B, H, S, D), the counterpart of
    the JAX ``xla_attention`` (the route for shapes no kernel takes).
    bias: optional additive f32 logits bias broadcast to (B, H, Sq, Skv)
    (T5's relative position bias). causal_offset: the absolute position
    of query row 0 (a prefill chunk against a KV cache): under ``causal``
    row r sees the keys up to column causal_offset + r."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[1] // k.shape[1]
    kf = _repeat_kv(k, group).float()
    vf = _repeat_kv(v, group).float()
    s = (q.float() @ kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    s = _mask_scores(s, kv_mask, causal, causal_offset)
    return (torch.softmax(s, dim=-1) @ vf).to(q.dtype)


# ------------------------------------------------------------------ CUDA

def _bind(lib):
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.x2i_flash_fwd.argtypes = [
        p, p, p, p, p, p, p, p, p, ll, p, ll, p, ll, p, ll,
        i, i, i, i, i, i, i, i, i, i, f, f, p]
    lib.x2i_flash_fwd_f32.argtypes = [
        p, p, p, p, p, p, p, p, p, ll, p, ll, p, ll, p, ll,
        i, i, i, i, i, i, i, i, f, f, p]
    lib.x2i_flash_fwd_blocks_per_sm.argtypes = [i, i, i, p]
    for name in ("x2i_flash_fwd", "x2i_flash_fwd_f32",
                 "x2i_flash_fwd_blocks_per_sm"):
        getattr(lib, name).restype = ctypes.c_int


def _bind_chunked(lib):
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.x2i_flash_chunked.argtypes = [
        p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, f, p]
    lib.x2i_flash_chunked_f32.argtypes = [
        p, p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, f, p]
    lib.x2i_flash_chunked.restype = ctypes.c_int
    lib.x2i_flash_chunked_f32.restype = ctypes.c_int


def _bind_bwd(lib):
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.x2i_flash_bwd_dq.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, ll, p, ll,
        i, i, i, i, i, i, i, f, f, p]
    lib.x2i_flash_bwd_dkv.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, p, p, p, ll, p, ll,
        i, i, i, i, i, i, i, f, f, p]
    lib.x2i_flash_bwd_dq_f32.argtypes = [
        p, p, p, p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, f, f, p]
    lib.x2i_flash_bwd_dkv_f32.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, p, p, ll,
        i, i, i, i, i, i, i, f, f, p]
    lib.x2i_flash_bwd_dkv_block_rows.argtypes = [i]
    for name in ("x2i_flash_bwd_dq", "x2i_flash_bwd_dkv",
                 "x2i_flash_bwd_dq_f32", "x2i_flash_bwd_dkv_f32",
                 "x2i_flash_bwd_dkv_block_rows"):
        getattr(lib, name).restype = ctypes.c_int


# the compiled forward library and its launch counts: ``flash_fwd_rope``
# for the rope variant without lse (K1a, FLUX serving), ``flash_fwd`` for
# the exact body without rope or lse (K1b, LM prefill), ``flash_fwd_pipe``
# for the pipelined body without rope (K1c, the DiT with rope outside, as
# the distillation teacher runs it), ``flash_fwd_lse`` for every forward
# that writes the lse (the exact body, with or without rope),
# ``flash_fwd_f32`` for every forward on f32 inputs without the lse or
# rope (any body), ``flash_fwd_rope_f32`` for the f32 rope-and-norm
# instance, ``flash_fwd_lse_f32`` for every f32 forward with the lse; at
# D = 256 every forward counts apart, under these names with ``_d256``
# (``launch_name``)
KERNEL = CudaLibrary("flash_fwd.cu", "libx2i_flash",
                     ("flash_fwd_rope", "flash_fwd", "flash_fwd_pipe",
                      "flash_fwd_lse", "flash_fwd_f32", "flash_fwd_lse_f32",
                      "flash_fwd_rope_f32", "flash_fwd_rope_d256",
                      "flash_fwd_d256", "flash_fwd_pipe_d256",
                      "flash_fwd_lse_d256", "flash_fwd_f32_d256",
                      "flash_fwd_lse_f32_d256", "flash_fwd_rope_f32_d256"),
                     _bind,
                     # every instance, and by name the D = 256 ones, the
                     # f32 rope-and-norm one at D = 128 and the D = 64
                     # one at three blocks an SM (mangled: <D, WGS, MINB,
                     # ROPE, BODY, float>)
                     wgmma_kernels=("flash_fwd_kernel",
                                    "flash_fwd_kernelILi256E",
                                    "flash_fwd_kernelILi128ELi2ELi1ELb1ELi0EfE",
                                    "flash_fwd_kernelILi64ELi1ELi3E"),
                     checked_kernels=("round_rows_kernel",))
# K2, the chunked forward above MAX_KV_SEQ kv tokens, and its f32 instance,
# counted apart at D = 256
KERNEL_CHUNKED = CudaLibrary("flash_chunked.cu", "libx2i_flash_chunked",
                             ("flash_chunked", "flash_chunked_f32",
                              "flash_chunked_d256", "flash_chunked_f32_d256"),
                             _bind_chunked,
                             wgmma_kernels=("flash_chunked_kernel",
                                            "flash_chunked_kernelILi256E"),
                             checked_kernels=("round_rows_kernel",))


# K1's grid instances, (head dim, consumer warpgroups, blocks an SM): a
# block is 64 q rows a warpgroup. The 128-row instance at every head dim;
# the 64-row one alone on an SM; at D = 64 the 64-row one with a smaller
# ring and register budget, three blocks an SM (csrc/flash_fwd.cu Tiles)
FWD_INSTANCES = ((64, 2, 1), (64, 1, 1), (64, 1, 3), (128, 2, 1),
                 (128, 1, 1), (256, 2, 1), (256, 1, 1))


def fwd_instance(batch: int, heads: int, q_rows: int, d: int,
                 sms: int) -> tuple:
    """K1's grid instance for a bf16 launch -> (consumer warpgroups, blocks
    an SM). ``blocks`` counts 128-row q tiles over heads and batch:

    * 64-row blocks where twice as many still fit in one wave on the
      card's ``sms`` (the LM prefill at 14 or 16 heads; the 28-head LM's
      112 128-row blocks stay one wave, as 224 64-row blocks they took
      two);
    * at D = 64, where the 128-row blocks take more than one wave and the
      64-row blocks fit one wave at three an SM (InternViT-300M's 144,
      CLIP ViT-L/14's 192): those;
    * else the 128-row blocks, one an SM."""
    blocks = batch * heads * (q_rows // 128)
    if 2 * blocks <= sms:
        return (1, 1)
    if d == 64 and sms < blocks and 2 * blocks <= 3 * sms:
        return (1, 3)
    return (2, 1)


def fwd_blocks_per_sm(d: int, wgs: int, blocks_per_sm: int) -> int:
    """The blocks of the bf16 instance that one SM of the current card
    holds at once, as CUDA's occupancy calculator counts them: what the
    instance is built for, or fewer if its registers or shared memory do
    not fit."""
    out = ctypes.c_int(0)
    err = KERNEL.lib().x2i_flash_fwd_blocks_per_sm(d, wgs, blocks_per_sm,
                                                   ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"flash kernel occupancy failed: cudaError_t "
                           f"{err}")
    return out.value


def launch_name(name: str, d: int) -> str:
    """The launch count a kernel of head dim d raises: ``name``, or at
    D = 256 ``name`` + "_d256"."""
    return f"{name}_d256" if d == 256 else name


# K4's instances at D = 256 (csrc/flash_bwd.cu flash_bwd_dkv_roles_kernel,
# mangled <ROPE, MASKED, OutT>): bf16 with and without rope and masks, f32
# with and without masks
DKV_ROLES_INSTANCES = tuple(
    f"flash_bwd_dkv_roles_kernelILb{rope}ELb{masked}E{out}E"
    for rope, masked, out in ((0, 0, "13__nv_bfloat16"),
                              (0, 1, "13__nv_bfloat16"),
                              (1, 0, "13__nv_bfloat16"),
                              (1, 1, "13__nv_bfloat16"), (0, 0, "f"),
                              (0, 1, "f")))
# the backward library: K3 and K4, and their f32 instances, counted apart
# at D = 256
KERNEL_BWD = CudaLibrary("flash_bwd.cu", "libx2i_flash_bwd",
                         ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_f32",
                          "flash_bwd_dkv_f32", "flash_bwd_dq_d256",
                          "flash_bwd_dkv_d256", "flash_bwd_dq_f32_d256",
                          "flash_bwd_dkv_f32_d256"), _bind_bwd,
                         # every instance, and by name the D = 256 ones
                         # (mangled: K3 <D, ROPE, MASKED, OutT>, K4's
                         # roles kernel <ROPE, MASKED, OutT>)
                         wgmma_kernels=("flash_bwd_dq_kernel",
                                        "flash_bwd_dkv_kernel",
                                        "flash_bwd_dq_kernelILi256E",
                                        *DKV_ROLES_INSTANCES),
                         checked_kernels=("round_rows_kernel",
                                          "dkv_reduce_kernelILi256E"))
# the launches of K4's reduce kernel, which sums the f32 partial sums of a
# split (``dkv_reduces``); not one of the path's kernels' counts
DKV_REDUCE_LAUNCHES = {"dkv_reduce": 0}


def check_rows(name, shape, strides, data_ptr, ndim=4, itemsize=2):
    """The layout the kernels' row loads take: ``ndim`` dims, the last
    contiguous, the other strides multiples of 16 bytes (8 elements of
    bf16, 4 of f32: the f32 instances round rows four channels at a time)
    and a 16-byte aligned start; raises ValueError otherwise."""
    if len(shape) != ndim or strides[-1] != 1:
        raise ValueError(f"flash kernel: {name} must be {ndim}-d with a "
                         f"contiguous last dim, got {tuple(shape)} "
                         f"strides {tuple(strides)}")
    if any(s * itemsize % 16 for s in strides[:-1]) or data_ptr % 16:
        raise ValueError(f"flash kernel: {name} needs 16-byte aligned rows")


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def instance_dtype(*dtypes) -> torch.dtype:
    """The kernels' instance that inputs of these dtypes take: bf16 or f32,
    all alike; raises ValueError otherwise."""
    if dtypes[0] not in KERNEL_DTYPES or any(d != dtypes[0] for d in dtypes):
        raise ValueError(f"flash kernel: inputs must be all torch.bfloat16 "
                         f"or all torch.float32, got {list(dtypes)}")
    return dtypes[0]


def f32_scratch_numel(q_shape, k_shape, with_do: bool = False) -> int:
    """bf16 elements of an f32 instance's scratch buffer: q, k and v (and
    with ``with_do``, the backward's, do after them) rounded to bf16, each
    contiguous."""
    b, hq, sq, d = q_shape
    hk, skv = k_shape[1], k_shape[2]
    return b * d * ((2 if with_do else 1) * hq * sq + 2 * hk * skv)


def _check(name, t, ndim, dtype=torch.bfloat16):
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"flash kernel: {name} must be a {dtype} CUDA "
                         f"tensor, got {t.dtype} on {t.device}")
    check_rows(name, t.shape, t.stride(), t.data_ptr(), ndim,
               t.element_size())


def _f32_table(name, t, rows, cols):
    if (t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2
            or t.shape[0] != rows or t.shape[1] < cols or t.stride(1) != 1):
        raise ValueError(f"flash kernel: {name} must be a CUDA f32 "
                         f"({rows}, >={cols}) table, got {tuple(t.shape)}")
    return t


def _rows_f32(name, t, shape, device):
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"flash kernel: {name} must be a contiguous f32 "
                         f"{shape} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _qk_scale(w, s, d):
    """-> (f32 table, row stride): a (D,) scale is shared (stride 0); an
    (S, D) table is rounded to bf16 first, as the TPU kernel stores it."""
    if w.dim() == 1:
        return _f32_table("qk scale", w.float().contiguous()[None], 1, d), 0
    return _f32_table("qk scale", w.to(torch.bfloat16).float().contiguous(),
                      s, d), d


def check_shapes(q_shape, k_shape, v_shape, extra=()):
    """The shapes a flash kernel takes -> (b, hq, hk, sq, skv, d): q
    (B, Hq, Sq, D), k and v (B, Hk, Skv, D) with Hq a multiple of Hk, D in
    ``HEAD_DIMS``, Sq and Skv multiples of 64 (K2's tiles overhang a last
    64 rows; K1, K3 and K4 ask for 128 on top: ``check_kernel_shapes``),
    and each shape in ``extra`` equal to q's; raises ValueError
    otherwise."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        raise ValueError(f"flash kernel: unsupported shapes q "
                         f"{tuple(q_shape)} k {tuple(k_shape)}")
    b, hq, sq, d = q_shape
    hk, skv = k_shape[1], k_shape[2]
    if (tuple(k_shape) != tuple(v_shape) or k_shape[0] != b
            or k_shape[3] != d or hk < 1 or hq % hk or d not in HEAD_DIMS
            or sq < 64 or skv < 64 or sq % 64 or skv % 64
            or any(tuple(e) != tuple(q_shape) for e in extra)):
        raise ValueError(f"flash kernel: unsupported shapes q "
                         f"{tuple(q_shape)} k {tuple(k_shape)} v "
                         f"{tuple(v_shape)}")
    return b, hq, hk, sq, skv, d


def check_kernel_shapes(q_shape, k_shape, v_shape, extra=()):
    """``check_shapes`` with Sq and Skv multiples of 128: the shapes K1
    (with and without the lse), K3 and K4 take; raises ValueError
    otherwise."""
    shapes = check_shapes(q_shape, k_shape, v_shape, extra)
    sq, skv = shapes[3], shapes[4]
    if sq % 128 or skv % 128:
        raise ValueError(f"flash kernel: unsupported shapes: K1, K3 and K4 "
                         f"take Sq and Skv in multiples of 128, got {sq} "
                         f"and {skv}")
    return shapes


def _shapes(q, k, v, extra=(), check=check_shapes):
    """Check q, k, v (and the (B, Hq, Sq, D) tensors in ``extra``), all
    bf16 or all f32, by ``check`` -> (b, hq, hk, sq, skv, d)."""
    tensors = (("q", q), ("k", k), ("v", v), *extra)
    dtype = instance_dtype(*(t.dtype for _, t in tensors))
    for name, t in tensors:
        _check(name, t, 4, dtype)
    return check(q.shape, k.shape, v.shape, [t.shape for _, t in extra])


def _mask_arg(kv_mask, b, skv, device):
    if kv_mask is None:
        return None, 0
    if (kv_mask.dtype != torch.bool or kv_mask.shape != (b, skv)
            or kv_mask.stride(1) != 1 or kv_mask.device != device):
        raise ValueError("flash kernel: kv_mask must be a (B, Skv) bool "
                         "CUDA tensor with contiguous rows")
    return kv_mask, kv_mask.stride(0)


def _rope_args(rope, sq, skv, d):
    if rope is None:
        return None, None, 0
    if sq != skv:
        raise ValueError("flash kernel: rope needs Sq == Skv")
    cos = _f32_table("cos", rope[0], sq, d // 2)
    sin = _f32_table("sin", rope[1], sq, d // 2)
    if sin.stride(0) != cos.stride(0):
        raise ValueError("flash kernel: cos and sin strides differ")
    return cos, sin, cos.stride(0)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _out_bhsd(b, h, s, d, like):
    """A (B, H, S, D) output laid out (B, S, H, D), as the dispatcher
    transposes it back."""
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _no_rope_f32(what, rope):
    if rope is not None:
        raise ValueError(f"flash kernel: {what} in f32 takes no rope inside: "
                         f"rotate q and k first (flash_attention does when "
                         f"autograd records)")


def _scratch(q, k, with_do=False):
    return torch.empty((f32_scratch_numel(q.shape, k.shape, with_do),),
                       dtype=torch.bfloat16, device=q.device)


def _rope_norm_args(rope, qk_norm, sq, skv, d):
    """-> (cos, sin, table row stride, q scale, its row stride, k scale,
    its row stride, eps): the rope tables and the qk-norm scales as the
    kernel takes them (nulls without)."""
    cos, sin, tab_rs = _rope_args(rope, sq, skv, d)
    if qk_norm is None:
        return cos, sin, tab_rs, None, 0, None, 0, 1e-6
    if rope is None:
        raise ValueError("flash kernel: qk_norm rides the rope path")
    (qw, qw_rs), (kw, kw_rs) = (_qk_scale(qk_norm[0], sq, d),
                                _qk_scale(qk_norm[1], skv, d))
    return cos, sin, tab_rs, qw, qw_rs, kw, kw_rs, float(qk_norm[2])


def _flash_cuda(q, k, v, kv_mask, causal, scale, rope, qk_norm,
                return_lse=False):
    """K1 on bf16 inputs, or its f32 instances on f32 ones (q, k, v rounded
    to bf16 on the card, o and the lse written in f32; with rope tables
    the rope-and-norm instance, whose rounding points are the bf16 K1a's
    on the rounded inputs). With the lse (the forward of
    ``_FlashAttention``) rope in f32 is refused, as the f32 backward
    kernels take none."""
    f32 = q.dtype == torch.float32
    if f32 and return_lse:
        _no_rope_f32("K1 with the lse", rope)
    b, hq, hk, sq, skv, d = _shapes(q, k, v, check=check_kernel_shapes)
    exact = return_lse or is_exact(kv_mask, causal, skv)
    cos, sin, tab_rs, qw, qw_rs, kw, kw_rs, eps = _rope_norm_args(
        rope, qk_norm, sq, skv, d)
    mask, mask_sb = _mask_arg(kv_mask, b, skv, q.device)
    out = _out_bhsd(b, hq, sq, d, q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    # the f32 instances' rounded q, k (under rope normalized and rotated)
    # and v; the bf16 one's rotated K under rope. Like every buffer here it
    # is allocated on the launch stream, so the caching allocator reuses it
    # only after the kernel
    if f32:
        scratch = _scratch(q, k)
    elif rope is not None:
        scratch = torch.empty((b, hk, skv, d), dtype=k.dtype, device=k.device)
    else:
        scratch = None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = KERNEL.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(lse), _ptr(scratch), strides, _ptr(cos), _ptr(sin), tab_rs,
            _ptr(qw), qw_rs, _ptr(kw), kw_rs, _ptr(mask), mask_sb, b, hq, hk,
            sq, skv, d, int(causal), int(exact))
    tail = (scale * LOG2_E, eps, _stream(q))
    if f32:
        err = lib.x2i_flash_fwd_f32(*args, *tail)
    else:
        err = lib.x2i_flash_fwd(
            *args, *fwd_instance(b, hq, sq, d, _sm_count(q.device)), *tail)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError_t {err}")
    if return_lse:
        name = "flash_fwd_lse_f32" if f32 else "flash_fwd_lse"
    elif f32:
        name = ("flash_fwd_rope_f32" if rope is not None
                else "flash_fwd_f32")
    else:
        name = ("flash_fwd_rope" if rope is not None else
                "flash_fwd" if exact else "flash_fwd_pipe")
    KERNEL.launches[launch_name(name, d)] += 1
    return (out, lse) if return_lse else out


def _flash_chunked_cuda(q, k, v, kv_mask, causal, scale, return_lse=False):
    """K2, or its f32 instance on f32 inputs (rounded to bf16 on the card
    into a scratch buffer, o and the lse written in f32)."""
    b, hq, hk, sq, skv, d = _shapes(q, k, v)
    f32 = q.dtype == torch.float32
    mask, mask_sb = _mask_arg(kv_mask, b, skv, q.device)
    out = _out_bhsd(b, hq, sq, d, q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = KERNEL_CHUNKED.lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(lse))
    rest = (strides, _ptr(mask), mask_sb, b, hq, hk, sq, skv, d, int(causal),
            scale * LOG2_E, _stream(q))
    scratch = _scratch(q, k) if f32 else None
    err = (lib.x2i_flash_chunked_f32(*ptrs, scratch.data_ptr(), *rest)
           if f32 else lib.x2i_flash_chunked(*ptrs, *rest))
    if err != 0:
        raise RuntimeError(f"chunked flash kernel launch failed: "
                           f"cudaError_t {err}")
    KERNEL_CHUNKED.launches[launch_name(
        "flash_chunked_f32" if f32 else "flash_chunked", d)] += 1
    return (out, lse) if return_lse else out


def _bwd_args(q, k, v, do, lse, delta, kv_mask, rope):
    b, hq, hk, sq, skv, d = _shapes(q, k, v, (("do", do),),
                                    check_kernel_shapes)
    for name, t in (("lse", lse), ("delta", delta)):
        _rows_f32(name, t, (b, hq, sq), q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must be 16-byte aligned")
    mask, mask_sb = _mask_arg(kv_mask, b, skv, q.device)
    cos, sin, tab_rs = _rope_args(rope, sq, skv, d)
    return (b, hq, hk, sq, skv, d), (mask, mask_sb), (cos, sin, tab_rs)


def _bwd_dq_cuda(q, k, v, do, lse, delta, kv_mask, causal, scale, rope):
    """K3, or its f32 instance on f32 inputs (q, k, v and do rounded to
    bf16 on the card into a scratch buffer, dq written in f32; no rope)."""
    (b, hq, hk, sq, skv, d), (mask, mask_sb), (cos, sin, tab_rs) = \
        _bwd_args(q, k, v, do, lse, delta, kv_mask, rope)
    f32 = q.dtype == torch.float32
    dq = _out_bhsd(b, hq, sq, d, q)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3])
    lib = KERNEL_BWD.lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    tail = (_ptr(mask), mask_sb, b, hq, hk, sq, skv, d, int(causal), scale,
            scale * LOG2_E, _stream(q))
    if f32:
        _no_rope_f32("K3", rope)
        scratch = _scratch(q, k, with_do=True)
        err = lib.x2i_flash_bwd_dq_f32(*ptrs, scratch.data_ptr(), strides,
                                       *tail)
    else:
        scratch = (torch.empty((b, hk, skv, d), dtype=k.dtype,
                               device=k.device) if rope is not None else None)
        err = lib.x2i_flash_bwd_dq(*ptrs, _ptr(scratch), strides, _ptr(cos),
                                   _ptr(sin), tab_rs, *tail)
    if err != 0:
        raise RuntimeError(f"flash dq kernel launch failed: cudaError_t "
                           f"{err}")
    KERNEL_BWD.launches[launch_name(
        "flash_bwd_dq_f32" if f32 else "flash_bwd_dq", d)] += 1
    return dq


def dkv_splits(blocks: int, stages: int, sms: int) -> int:
    """How many shares K4 splits each block's ``stages`` (GQA group x
    64-row q tiles) into: 1 where its ``blocks`` (kv tiles x kv heads x
    batch; a tile is 128 rows, 64 at D = 256) fill the card's ``sms``,
    else enough for about one block per SM, each share non-empty."""
    if blocks >= sms:
        return 1
    per = -(-stages // min(stages, -(-sms // blocks)))
    return -(-stages // per)


def dkv_reduces(splits: int) -> bool:
    """Whether K4 writes f32 partial sums that the library's reduce
    kernel sums in split order, counter-rotates (with rope) and writes:
    with a split alone. Without one every instance writes its outputs
    itself, with rope too (at D = 256 the warpgroup that keeps dk holds
    each column's rotation partner)."""
    return splits > 1


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """The card's SM count, asked once per device (every K1 launch reads
    it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bwd_dkv_cuda(q, k, v, do, lse, delta, kv_mask, causal, scale, rope):
    """K4, or its f32 instance on f32 inputs (q, k, v and do rounded to
    bf16 on the card into a scratch buffer, dk and dv written in f32; no
    rope)."""
    (b, hq, hk, sq, skv, d), (mask, mask_sb), (cos, sin, tab_rs) = \
        _bwd_args(q, k, v, do, lse, delta, kv_mask, rope)
    f32 = q.dtype == torch.float32
    dk, dv = _out_bhsd(b, hk, skv, d, k), _out_bhsd(b, hk, skv, d, v)
    lib = KERNEL_BWD.lib()
    splits = dkv_splits(skv // lib.x2i_flash_bwd_dkv_block_rows(d) * hk * b,
                        hq // hk * sq // 64, _sm_count(q.device))
    # the f32 partial dk and dv of a split, summed, counter-rotated and
    # written by the library's reduce kernel
    reduce = dkv_reduces(splits)
    partial = (torch.empty((2, splits, b, hk, skv, d), dtype=torch.float32,
                           device=q.device) if reduce else None)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tail = (_ptr(mask), mask_sb, b, hq, hk, sq, skv, d, int(causal), scale,
            scale * LOG2_E, _stream(q))
    if f32:
        _no_rope_f32("K4", rope)
        scratch = _scratch(q, k, with_do=True)
        err = lib.x2i_flash_bwd_dkv_f32(*ptrs, scratch.data_ptr(),
                                        _ptr(partial), splits, strides, *tail)
    else:
        scratch = (torch.empty((b, hq, sq, d), dtype=q.dtype,
                               device=q.device) if rope is not None else None)
        err = lib.x2i_flash_bwd_dkv(*ptrs, _ptr(scratch), _ptr(partial),
                                    splits, strides, _ptr(cos), _ptr(sin),
                                    tab_rs, *tail)
    if err != 0:
        raise RuntimeError(f"flash dk/dv kernel launch failed: cudaError_t "
                           f"{err}")
    KERNEL_BWD.launches[launch_name(
        "flash_bwd_dkv_f32" if f32 else "flash_bwd_dkv", d)] += 1
    DKV_REDUCE_LAUNCHES["dkv_reduce"] += int(reduce)
    return dk, dv


# ------------------------------------------------------ the wrappers

def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_forward_lse(q, k, v, kv_mask=None, causal=False, scale=None,
                      rope=None):
    """K1 with the lse (the exact body): -> (o (B, Hq, Sq, D), lse f32
    (B, Hq, Sq), base 2). A CUDA tensor launches the kernel, a CPU tensor
    takes ``flash_attention_plain``. Not differentiable itself: it is the
    forward of ``_FlashAttention``."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, causal, scale, rope,
                                     return_lse=True)
    return _flash_cuda(q, k, v, kv_mask, causal, scale, rope, None,
                       return_lse=True)


def flash_forward_chunked(q, k, v, kv_mask=None, causal=False, scale=None,
                          return_lse=False):
    """K2, the online softmax over kv tiles: -> o (B, Hq, Sq, D) and,
    with ``return_lse``, the f32 (B, Hq, Sq) base-2 lse. q (B, Hq, Sq, D),
    k and v (B, Hk, Skv, D), Sq != Skv allowed, no rope and no qk norm
    inside. A CUDA tensor launches the kernel, a CPU tensor takes
    ``flash_forward_chunked_plain``. Forward-only: it is the forward of
    ``_FlashAttention`` above ``MAX_KV_SEQ``."""
    refuse_grad("the chunked flash kernel", q, k, v)
    scale = _default_scale(q, scale)
    fn = (flash_forward_chunked_plain if q.device.type == "cpu"
          else _flash_chunked_cuda)
    return fn(q, k, v, kv_mask, causal, scale, return_lse)


def flash_bwd_dq(q, k, v, do, lse, delta, kv_mask=None, causal=False,
                 scale=None, rope=None):
    """K3: dq from the forward's lse and delta = sum(do * o). A CUDA
    tensor launches the kernel, a CPU tensor takes ``flash_bwd_dq_plain``."""
    scale = _default_scale(q, scale)
    fn = flash_bwd_dq_plain if q.device.type == "cpu" else _bwd_dq_cuda
    return fn(q, k, v, do, lse, delta, kv_mask, causal, scale, rope)


def flash_bwd_dkv(q, k, v, do, lse, delta, kv_mask=None, causal=False,
                  scale=None, rope=None):
    """K4: (dk, dv), the GQA group summed. A CUDA tensor launches the
    kernel, a CPU tensor takes ``flash_bwd_dkv_plain``."""
    scale = _default_scale(q, scale)
    fn = flash_bwd_dkv_plain if q.device.type == "cpu" else _bwd_dkv_cuda
    return fn(q, k, v, do, lse, delta, kv_mask, causal, scale, rope)


def flash_backward(q, k, v, kv_mask, o, lse, do, causal=False, scale=None,
                   rope=None):
    """K3 then K4: (dq, dk, dv) in the inputs' dtypes."""
    delta = _delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, kv_mask, causal, scale, rope)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, kv_mask, causal,
                               scale, rope))


class _FlashAttention(torch.autograd.Function):
    """K1 with the lse forward, K3/K4 backward: the JAX ``_flash``
    ``custom_vjp`` with the branches of its ``_flash_bwd``. Rope tables
    given here are applied inside the kernels (bf16, Skv <= ROPE_MAX_KV);
    ``flash_attention`` rotates outside above that and for f32, and
    autograd carries the rotation's transpose. Above MAX_KV_SEQ the
    forward is K2 with the lse and the backward recomputes through the
    plain attention. f32 inputs take each kernel's f32 instance."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, cos, sin, causal, scale):
        rope = None if cos is None else (cos, sin)
        if k.shape[2] > MAX_KV_SEQ:
            if rope is not None:
                raise ValueError("above MAX_KV_SEQ the rope is applied "
                                 "outside the kernel")
            o, lse = flash_forward_chunked(q, k, v, kv_mask, causal, scale,
                                           return_lse=True)
        else:
            o, lse = flash_forward_lse(q, k, v, kv_mask, causal, scale,
                                       rope)
        ctx.save_for_backward(q, k, v, kv_mask, cos, sin, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, cos, sin, o, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        rope = None if cos is None else (cos, sin)
        if rope is None and k.shape[2] > MAX_KV_SEQ:
            with torch.enable_grad():
                args = [t.detach().requires_grad_() for t in (q, k, v)]
                out = xla_attention(*args, kv_mask, causal, scale)
                dq, dk, dv = torch.autograd.grad(out, args, do)
        else:
            dq, dk, dv = flash_backward(q, k, v, kv_mask, o, lse,
                                        do.contiguous(), causal, scale,
                                        rope)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None,
                    rope=None, qk_norm=None) -> torch.Tensor:
    """Flash attention over (B, H, S, D) tensors; differentiable, except
    with qk_norm inside the kernel.

    rope: optional (cos, sin) half-layout tables, each (S, D) f32,
    applied to q and k (Sq == Skv). qk_norm: optional (q_scale, k_scale,
    eps) with (D,) or per-row (S, D) scales: RMSNorm of q and k before the
    rotation (requires rope).

    Up to ``MAX_KV_SEQ`` kv tokens the norm and the rotation run inside
    K1; that route is forward-only with qk_norm, as in JAX, and raises
    when autograd records. Above ``MAX_KV_SEQ`` the forward is K2, and
    when autograd records above ``ROPE_MAX_KV`` it is ``_FlashAttention``
    with the rope outside: on both routes the norm runs first
    (``rms_norm``, rounded to the input dtype), then the rotation
    (``rope_bhsd``, rounded again), both outside the kernels and both
    differentiable, as JAX's ``flash_attention`` and ``_fwd_impl`` order
    them. f32 under autograd rotates outside at every length (the f32
    instances with the lse and the backward's take no rope; in f32 the
    rounding is the identity, so this is JAX's function), with qk_norm
    forward-only below ``ROPE_MAX_KV`` as before; f32 without autograd
    takes both inside K1's f32 rope-and-norm instance. Head dims 64, 128
    and 256 take every kernel, forward and backward.

    Without autograd recording, a CUDA tensor launches the forward kernel
    (which raises on what it does not take) and a CPU tensor takes the
    kernel's plain version. When it records, the call goes through
    ``_FlashAttention`` (the same routing for each of its kernels)."""
    scale = _default_scale(q, scale)
    chunked = k.shape[2] > MAX_KV_SEQ
    norm_scales = () if qk_norm is None else qk_norm[:2]
    recording = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, *norm_scales))
    # the routes that rotate outside the kernels normalize outside too
    rope_outside = chunked or (recording and k.shape[2] > ROPE_MAX_KV)
    if recording and qk_norm is not None and not rope_outside:
        refuse_grad("the flash kernel with qk_norm", q, k, v, *norm_scales)
    if rope_outside and qk_norm is not None:
        if rope is None:
            raise ValueError("flash kernel: qk_norm rides the rope path")
        qw, kw, eps = qk_norm
        q, k, qk_norm = rms_norm(q, qw, eps), rms_norm(k, kw, eps), None
    # f32 under autograd rotates outside at every length: the f32
    # instances with the lse take no rope, and the plain versions on the
    # CPU follow
    if rope is not None and (rope_outside or (
            recording and q.dtype == torch.float32)):
        q, k, rope = rope_bhsd(q, *rope), rope_bhsd(k, *rope), None
    if recording:
        cos, sin = (None, None) if rope is None else rope
        return _FlashAttention.apply(q, k, v, kv_mask, cos, sin, causal,
                                     scale)
    if chunked:
        return flash_forward_chunked(q, k, v, kv_mask, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, causal, scale, rope,
                                     qk_norm)
    return _flash_cuda(q, k, v, kv_mask, causal, scale, rope, qk_norm)
