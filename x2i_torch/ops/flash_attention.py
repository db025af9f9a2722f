"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` (K1), its
plain PyTorch version, and the plain attention for shapes the kernel does
not take.

Counterpart of ``x2i_tpu/ops/flash_attention.py`` (forward only). The TPU
kernel ``_flash_kernel`` has two forward bodies, and so do the plain
version here and the CUDA kernel:

* pipelined (no kv mask, not causal, Skv >= 256 -- the TPU rule that picks
  ``pipeline_kc``): softmax as ``exp2(clip(s, -100, 100))`` with no row
  max; FLUX joint attention, with the half-layout rope and the qk RMSNorm
  applied inside;
* exact (otherwise): kv mask and causal mask with the finite ``NEG_INF``,
  GQA, row-max softmax; the Qwen2 LM prefill.

The rounding points are the TPU kernel's: with rope, q after norm -> rope
-> ``* scale * log2(e)`` is rounded to the input dtype, rotated K likewise,
and ``p`` is cast to the input dtype before the PV product.

Rope tables are ``(S, D)`` f32 as ``flux_rope_freqs_half`` makes them,
cos = cat(c, c) and sin = cat(s, s); only their first halves are read, as
``apply_rope_half`` reads them.

``flash_attention`` launches the kernel for a CUDA tensor and takes the
plain version for a CPU tensor; there is no other fallback. The kernel is
built from the repository's source with ``nvcc`` at first use, into
``x2i_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from x2i_torch.ops.cuda_lib import CudaLibrary

NEG_INF = -1e30
LOG2_E = math.log2(math.e)
HEAD_DIMS = (64, 128)


def supported(q_shape, kv_seq: int) -> bool:
    """Whether the kernel applies to these shapes: the TPU rule
    (``supported``, S % 128 == 0) with the head sizes the CUDA kernel is
    built for (D = 256 waits for a later kernel)."""
    _, _, sq, d = q_shape
    return d in HEAD_DIMS and kv_seq % 128 == 0 and sq % 128 == 0


def is_exact(kv_mask, causal: bool, skv: int) -> bool:
    """The TPU kernel's choice of body: the pipelined one needs no mask,
    no causal mask and at least two 128-row kv chunks."""
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


def flash_attention_plain(q, k, v, kv_mask=None, causal=False, scale=None,
                          rope=None, qk_norm=None) -> torch.Tensor:
    """The kernel's function step by step in PyTorch: (B, Hq, Sq, D) q,
    (B, Hk, Skv, D) k/v, (B, Skv) bool kv_mask -> (B, Hq, Sq, D) in
    q.dtype."""
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
        kr = kr.repeat_interleave(group, dim=1)
        s = qr.float() @ kr.float().transpose(-1, -2)
    else:
        kf = k.repeat_interleave(group, dim=1).float()
        s = (q.float() @ kf.transpose(-1, -2)) * post
    vf = v.repeat_interleave(group, dim=1)
    if is_exact(kv_mask, causal, k.shape[2]):
        if kv_mask is not None:
            s = s.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
        if causal:
            sq, skv = s.shape[-2:]
            rows = torch.arange(sq, device=s.device)[:, None]
            cols = torch.arange(skv, device=s.device)[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
    else:
        p = torch.exp2(s.clamp(-100.0, 100.0))
    o = (p.to(v.dtype).float() @ vf.float()) / p.sum(-1, keepdim=True)
    return o.to(q.dtype)


def xla_attention(q, k, v, kv_mask=None, causal=False, scale=None
                  ) -> torch.Tensor:
    """Plain f32 softmax attention over (B, H, S, D), the counterpart of
    the JAX ``xla_attention`` (the route for shapes no kernel takes)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = (q.float() @ kf.transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    if causal:
        sq, skv = s.shape[-2:]
        rows = torch.arange(sq, device=s.device)[:, None]
        cols = torch.arange(skv, device=s.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return (torch.softmax(s, dim=-1) @ vf).to(q.dtype)


def _bind(lib):
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.x2i_flash_fwd.argtypes = [
        p, p, p, p, p, p, p, p, ll, p, ll, p, ll, p, ll,
        i, i, i, i, i, i, i, i, f, f, p]
    lib.x2i_flash_fwd.restype = ctypes.c_int


# the compiled library and its launch counts: ``flash_fwd_rope`` for the
# rope variant (K1a, FLUX), ``flash_fwd`` for the other (K1b, LM prefill)
KERNEL = CudaLibrary("flash_fwd.cu", "libx2i_flash",
                     ("flash_fwd_rope", "flash_fwd"), _bind)


def _check(name, t, ndim):
    if t.device.type != "cuda" or t.dtype != torch.bfloat16:
        raise ValueError(f"flash kernel: {name} must be a bf16 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if t.dim() != ndim or t.stride(-1) != 1:
        raise ValueError(f"flash kernel: {name} must be {ndim}-d with a "
                         f"contiguous last dim, got {tuple(t.shape)} "
                         f"strides {t.stride()}")
    if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"flash kernel: {name} needs 16-byte aligned rows")


def _f32_table(name, t, rows, cols):
    if (t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2
            or t.shape[0] != rows or t.shape[1] < cols or t.stride(1) != 1):
        raise ValueError(f"flash kernel: {name} must be a CUDA f32 "
                         f"({rows}, >={cols}) table, got {tuple(t.shape)}")
    return t


def _qk_scale(w, s, d):
    """-> (f32 table, row stride): a (D,) scale is shared (stride 0); an
    (S, D) table is rounded to bf16 first, as the TPU kernel stores it."""
    if w.dim() == 1:
        return _f32_table("qk scale", w.float().contiguous()[None], 1, d), 0
    return _f32_table("qk scale", w.to(torch.bfloat16).float().contiguous(),
                      s, d), d


def _flash_cuda(q, k, v, kv_mask, causal, scale, rope, qk_norm):
    b, hq, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, 4)
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hq % hk or d not in HEAD_DIMS or sq % 64 or skv % 64):
        raise ValueError(f"flash kernel: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    exact = is_exact(kv_mask, causal, skv)
    cos = sin = qw = kw = mask = scratch = None
    tab_rs = qw_rs = kw_rs = mask_sb = 0
    eps = 1e-6
    if rope is not None:
        if sq != skv:
            raise ValueError("flash kernel: rope needs Sq == Skv")
        cos = _f32_table("cos", rope[0], sq, d // 2)
        sin = _f32_table("sin", rope[1], sq, d // 2)
        tab_rs = cos.stride(0)
        if sin.stride(0) != tab_rs:
            raise ValueError("flash kernel: cos and sin strides differ")
        # rotated K, written once per launch; like every buffer here it is
        # allocated on the launch stream, so the caching allocator reuses
        # it only after the kernel
        scratch = torch.empty((b, hk, skv, d), dtype=k.dtype, device=k.device)
        if qk_norm is not None:
            (qw, qw_rs), (kw, kw_rs) = (_qk_scale(qk_norm[0], sq, d),
                                        _qk_scale(qk_norm[1], skv, d))
            eps = float(qk_norm[2])
    elif qk_norm is not None:
        raise ValueError("flash kernel: qk_norm rides the rope path")
    if kv_mask is not None:
        if (kv_mask.dtype != torch.bool or kv_mask.shape != (b, skv)
                or kv_mask.stride(1) != 1 or kv_mask.device != q.device):
            raise ValueError("flash kernel: kv_mask must be a (B, Skv) bool "
                             "CUDA tensor with contiguous rows")
        mask, mask_sb = kv_mask, kv_mask.stride(0)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = KERNEL.lib()
    err = lib.x2i_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ptr(scratch), strides, ptr(cos), ptr(sin), tab_rs, ptr(qw), qw_rs,
        ptr(kw), kw_rs, ptr(mask), mask_sb, b, hq, hk, sq, skv, d,
        int(causal), int(exact), scale * LOG2_E, eps,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError_t {err}")
    KERNEL.launches["flash_fwd_rope" if rope is not None else
                    "flash_fwd"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None,
                    rope=None, qk_norm=None) -> torch.Tensor:
    """Flash attention forward over (B, H, S, D) tensors.

    rope: optional (cos, sin) half-layout tables, each (S, D) f32,
    applied to q and k inside the kernel (Sq == Skv). qk_norm: optional
    (q_scale, k_scale, eps) with (D,) or per-row (S, D) scales: RMSNorm of
    q and k before the rotation (requires rope).

    A CUDA tensor launches the kernel (which raises on what it does not
    take); a CPU tensor takes ``flash_attention_plain``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, causal, scale, rope,
                                     qk_norm)
    return _flash_cuda(q, k, v, kv_mask, causal, scale, rope, qk_norm)
