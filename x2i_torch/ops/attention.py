"""Attention dispatcher, the counterpart of ``x2i_tpu/ops/attention.py``.

Tensors are (batch, seq, heads, head_dim) at this boundary. The
dispatcher picks the flash kernel by the JAX package's static rule (a
kernel off the CPU when ``supported``; with ``implementation="kernel"``
always), under "auto" for the inputs the CUDA kernels take (``route``);
it pads odd lengths to a multiple of 128 with masked keys, and applies
the qk RMSNorm and the rope here whenever the kernel route does not take
them (above ``MAX_KV_SEQ`` kv tokens ``flash_attention`` applies both
itself, ahead of the chunked kernel, also on the padded tensors of the
pad route). Every route is differentiable (the kernel route through the
flash kernels' autograd ``Function``), except the kernel route with
qk_norm, which is forward-only as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from x2i_torch.ops import flash_attention as fa
from x2i_torch.ops.norms import rms_norm
from x2i_torch.ops.rope import apply_rope_half


def route(q: torch.Tensor, k: torch.Tensor, causal: bool = False,
          implementation: str = "auto", bias=None,
          causal_offset: int = 0) -> str:
    """The dispatcher's static choice for q (B, Sq, Hq, D) against k (B,
    Skv, Hk, D): "kernel" (the flash kernel at these shapes), "pad" (the
    kernel on q, k and v padded to multiples of 128 with masked keys) or
    "plain". A bias or a causal offset takes the plain route (JAX's XLA
    path). "kernel" always takes a kernel route. "auto" takes one off the
    CPU for the dtypes the CUDA kernels have instances of, bf16 and f32,
    forward and backward at every length (K1 and its lse, K2 above
    ``MAX_KV_SEQ``, K3 and K4), as JAX's Pallas kernels take every dtype;
    any other dtype takes the plain route. Head dims 64, 128 and 256 take
    the kernels, forward and backward, as JAX's ``supported`` and its pad
    route do. Reads only shapes, dtype and device: meta tensors do."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    auto_ok = q.device.type != "cpu" and q.dtype in fa.KERNEL_DTYPES
    kernel_ok = bias is None and causal_offset == 0 and (
        implementation == "kernel" or (implementation == "auto" and auto_ok))
    if not kernel_ok:
        return "plain"
    if fa.supported((b, hq, sq, d), skv):
        return "kernel"
    if not causal and d in fa.HEAD_DIMS and (sq % 128 or skv % 128):
        return "pad"
    return "plain"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: Optional[torch.Tensor] = None,
              causal: bool = False,
              scale: Optional[float] = None,
              implementation: str = "auto",
              rope=None, qk_norm=None,
              bias: Optional[torch.Tensor] = None,
              causal_offset: int = 0) -> torch.Tensor:
    """Multi-head (optionally grouped-query) attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hk, D); kv_mask: optional (B, Skv)
    bool, True where the key is valid; implementation: "auto" | "kernel" |
    "plain". rope: optional (cos, sin) half-layout tables, each (S, D) f32,
    applied to q and k. qk_norm: optional (q_scale, k_scale, eps) with (D,)
    or per-row (S, D) scales, applied before the rope. bias: optional
    additive logits bias broadcast to (B, H, Sq, Skv) (T5's relative
    position bias); it takes the plain route, as it forces the XLA path in
    JAX. causal_offset: the absolute position of query row 0 (a prefill
    chunk against a KV cache); anything but 0 takes the plain route, as
    it takes the XLA path in JAX.

    Returns (B, Sq, Hq, D) in q.dtype."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    which = route(q, k, causal, implementation, bias, causal_offset)
    use_kernel, pad_path = which == "kernel", which == "pad"
    pad_q, pad_kv = (-sq) % 128, (-skv) % 128

    kernel_rope = (rope is not None and (use_kernel or pad_path)
                   and sq == skv and not causal)
    if qk_norm is not None and not kernel_rope:
        qw, kw, eps = qk_norm
        qw = qw if qw.dim() == 1 else qw[:, None, :]
        kw = kw if kw.dim() == 1 else kw[:, None, :]
        q, k = rms_norm(q, qw, eps), rms_norm(k, kw, eps)
        qk_norm = None
    if rope is not None and not kernel_rope:
        q, k = apply_rope_half(q, *rope), apply_rope_half(k, *rope)
        rope = None

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if pad_path:
        qp = F.pad(qt, (0, 0, 0, pad_q))
        kp = F.pad(kt, (0, 0, 0, pad_kv))
        vp = F.pad(vt, (0, 0, 0, pad_kv))
        mask = (kv_mask if kv_mask is not None else
                torch.ones((b, skv), dtype=torch.bool, device=q.device))
        mask = F.pad(mask.bool(), (0, pad_kv), value=False)
        if rope is not None:
            # zero table rows rotate pad rows to zero: pad keys are masked
            # out, pad q rows are sliced off below
            rope = tuple(F.pad(t, (0, 0, 0, pad_kv)) for t in rope)
        if qk_norm is not None:
            qk_norm = tuple(F.pad(w, (0, 0, 0, pad_kv)) if w.dim() == 2
                            else w for w in qk_norm[:2]) + (qk_norm[2],)
        out = fa.flash_attention(qp, kp, vp, kv_mask=mask, causal=False,
                                 scale=scale, rope=rope,
                                 qk_norm=qk_norm)[:, :, :sq]
    elif use_kernel:
        out = fa.flash_attention(qt, kt, vt, kv_mask=kv_mask, causal=causal,
                                 scale=scale, rope=rope, qk_norm=qk_norm)
    else:
        out = fa.xla_attention(qt, kt, vt, kv_mask=kv_mask, causal=causal,
                               scale=scale, bias=bias,
                               causal_offset=causal_offset)
    return out.transpose(1, 2)
