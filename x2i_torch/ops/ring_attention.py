"""Ring attention over a mesh axis, the counterpart of
``x2i_tpu/ops/ring_attention.py``.

The sequence is cut into one shard per member of the axis. Each member
attends its q shard to one kv shard at a time and merges the partial
outputs in log space by their base-2 logsumexp, while the kv shards move
one hop around the ring (``parallel/axis.py``: a roll of the members in
the one-process form, ``batch_isend_irecv`` in the process form). The
result is exact softmax attention over the whole sequence, not an
approximation (Liu et al. 2023).

Each (q shard, kv shard) pair takes K1 with its lse
(``flash_forward_lse``), or above ``MAX_KV_SEQ`` kv tokens a shard K2 with
its lse (``flash_forward_chunked(return_lse=True)``), as JAX's
``_fwd_impl`` routes them, on CUDA tensors of the kernels' dtypes (bf16
and f32) whose shards the kernels take, by their own shape check
(``kernels_take``), at every head dim they take (64, 128, 256); otherwise
(CPU tensors, other dtypes, "plain") the plain pair functions of JAX's XLA
route. The partials merge in f32, with one cast at the end of the ring.

The backward runs the ring again: dq accumulates in f32 on the owner of
q, while (k, v, dk, dv) make the full circle of n hops, each pair adding
its ``flash_backward`` (K3 then K4) against the global o and lse, so that
dk and dv arrive home at their owners.

``ring_attention`` takes whole (B, S, H, D) tensors on every member (the
token-wise work whole, as a process of the process form keeps it): each
member enters the ring with its contiguous chunk, and the outputs (and,
backward, the gradients) are gathered back whole.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from x2i_torch.ops import flash_attention as fa


def _attend_plain_lse(q, k, v, scale):
    """(B, H, Sq, D) x (B, H, Skv, D) -> (o, lse2): exact softmax attention
    in f32 and the base-2 per-row logsumexp, the kernels' convention (JAX's
    ``_attend_xla_lse``)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * (scale * fa.LOG2_E)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p / l) @ v.float()
    return o.to(q.dtype), (m + torch.log2(l))[..., 0]


def _pair_bwd_plain(q, k, v, o, lse, do, scale):
    """(dq, dk, dv) of one pair given the global lse, in f32 (JAX's
    ``_pair_bwd`` off the kernels)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, of = do.float(), o.float()
    s2 = (qf @ kf.transpose(-1, -2)) * (scale * fa.LOG2_E)
    p = torch.exp2(s2 - lse[..., None])          # globally normalized
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernels_take(q_shape, kv_seq: int, dtype) -> bool:
    """Whether the pair wrappers' kernels take a (B, H, Sq, D) q shard
    against kv_seq keys in ``dtype``: the forward with its lse (K1, or K2
    above ``MAX_KV_SEQ``) and K3 and K4, asked through their own shape
    check (``check_kernel_shapes``), so that this rule and the kernels
    cannot part."""
    if dtype not in fa.KERNEL_DTYPES:
        return False
    b, h, _, d = q_shape
    kv_shape = (b, h, kv_seq, d)
    try:
        fa.check_kernel_shapes(q_shape, kv_shape, kv_shape)
    except ValueError:
        return False
    return True


def use_kernels(q, kv_seq: int, implementation: str) -> bool:
    """Whether a pair takes the kernels' wrappers: always under "kernel"
    (on a CPU tensor their plain versions), under "auto" on a CUDA tensor
    whose dtype and shards they take (``kernels_take``), never under
    "plain"."""
    if implementation not in ("auto", "kernel", "plain"):
        raise ValueError(f"implementation={implementation!r}")
    return implementation == "kernel" or (
        implementation == "auto" and q.device.type == "cuda"
        and kernels_take(q.shape, kv_seq, q.dtype))


def _attend_lse(q, k, v, scale, implementation):
    """One pair's (o, lse)."""
    if not use_kernels(q, k.shape[2], implementation):
        return _attend_plain_lse(q, k, v, scale)
    if k.shape[2] > fa.MAX_KV_SEQ:
        return fa.flash_forward_chunked(q, k, v, scale=scale,
                                        return_lse=True)
    return fa.flash_forward_lse(q, k, v, scale=scale)


def _pair_bwd(q, k, v, o, lse, do, scale, implementation):
    if not use_kernels(q, k.shape[2], implementation):
        return _pair_bwd_plain(q, k, v, o, lse, do, scale)
    return fa.flash_backward(q, k, v, None, o, lse, do, scale=scale)


def _merge(o, lse, o2, lse2):
    """The log-space merge of two normalized partials: softmax over both
    key sets is w1 * o1 + w2 * o2 with w_i = exp2(lse_i - lse); the
    accumulator o stays f32."""
    m = torch.maximum(lse, lse2)
    w1, w2 = torch.exp2(lse - m), torch.exp2(lse2 - m)
    denom = w1 + w2
    of = (o.float() * (w1 / denom)[..., None]
          + o2.float() * (w2 / denom)[..., None])
    return of, m + torch.log2(denom)


def ring_forward(qs, ks, vs, axis, scale: float,
                 implementation: str = "auto"):
    """The ring over the members this process holds: lists of (B, H, S/n,
    D) shards aligned with ``axis.members`` -> (o shards in q's dtype,
    f32 lse shards (B, H, S/n))."""
    res = [_attend_lse(q, k, v, scale, implementation)
           for q, k, v in zip(qs, ks, vs)]
    os_, lses = [o for o, _ in res], [l for _, l in res]
    if axis.size == 1:
        return os_, lses
    os_ = [o.float() for o in os_]
    kv = list(zip(ks, vs))
    for _ in range(axis.size - 1):
        kv = axis.shift(kv)
        for i, (q, (k, v)) in enumerate(zip(qs, kv)):
            o2, lse2 = _attend_lse(q, k, v, scale, implementation)
            os_[i], lses[i] = _merge(os_[i], lses[i], o2, lse2)
    return [o.to(q.dtype) for o, q in zip(os_, qs)], lses


def ring_backward(qs, ks, vs, os_, lses, dos, axis, scale: float,
                  implementation: str = "auto"):
    """The reverse ring: -> (dq, dk, dv) shard lists in the inputs'
    dtypes; (k, v, dk, dv) travel n hops, back to their owners."""
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    state = [(k, v, torch.zeros(k.shape, dtype=torch.float32,
                                device=k.device),
              torch.zeros(v.shape, dtype=torch.float32, device=v.device))
             for k, v in zip(ks, vs)]
    for _ in range(axis.size):
        for i, (kc, vc, dkc, dvc) in enumerate(state):
            dq_c, dk_c, dv_c = _pair_bwd(qs[i], kc, vc, os_[i], lses[i],
                                         dos[i], scale, implementation)
            dq[i] = dq[i] + dq_c.float()
            state[i] = (kc, vc, dkc + dk_c.float(), dvc + dv_c.float())
        if axis.size > 1:
            state = axis.shift(state)
    return ([d.to(q.dtype) for d, q in zip(dq, qs)],
            [s[2].to(k.dtype) for s, k in zip(state, ks)],
            [s[3].to(v.dtype) for s, v in zip(state, vs)])


def _chunks(x: torch.Tensor, axis) -> List[torch.Tensor]:
    """This process's members' chunks of dim 2 (views)."""
    c = x.shape[2] // axis.size
    return [x.narrow(2, m * c, c) for m in axis.members]


def ring_forward_lse(q, k, v, axis, scale: Optional[float] = None,
                     implementation: str = "auto"):
    """Whole (B, H, S, D) tensors -> the whole (o, lse), every member
    entering the ring with its chunk; not differentiable."""
    scale = fa._default_scale(q, scale)
    os_, lses = ring_forward(_chunks(q, axis), _chunks(k, axis),
                             _chunks(v, axis), axis, scale, implementation)
    return axis.gather(os_, 2), axis.gather(lses, 2)


def ring_grads(q, k, v, o, lse, do, axis, scale: Optional[float] = None,
               implementation: str = "auto"):
    """Whole (B, H, S, D) q, k, v, o, do and the whole (B, H, S) lse of
    ``ring_forward_lse`` -> the whole (dq, dk, dv) by the reverse ring."""
    scale = fa._default_scale(q, scale)
    dq, dk, dv = ring_backward(
        *(_chunks(x, axis) for x in (q, k, v, o)),
        [c.contiguous() for c in _chunks(lse, axis)], _chunks(do, axis),
        axis, scale, implementation)
    return axis.gather(dq, 2), axis.gather(dk, 2), axis.gather(dv, 2)


class _RingAttention(torch.autograd.Function):
    """The ring's forward and its reverse-ring backward on whole (B, H, S,
    D) tensors (JAX's ``_ring`` ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, scale, implementation):
        o, lse = ring_forward_lse(q, k, v, axis, scale, implementation)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.axis, ctx.scale, ctx.implementation = axis, scale, implementation
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_grads(q, k, v, o, lse, do.contiguous(), ctx.axis,
                                ctx.scale, ctx.implementation)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                   scale: Optional[float] = None,
                   implementation: str = "auto") -> torch.Tensor:
    """Exact attention of (B, S, H, D) q, k, v (rope already applied) over
    the ring of ``axis``: -> (B, S, H, D) in q's dtype, differentiable
    (the reverse-ring backward). S must divide into the ring's members."""
    n = axis.size
    if q.shape[1] % n:
        raise ValueError(f"ring_attention: seq {q.shape[1]} not divisible "
                         f"by ring size {n}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out = _RingAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), axis, float(scale),
                               implementation)
    return out.transpose(1, 2)
