"""FLUX-class rectified-flow DiT, the counterpart of
``x2i_tpu/models/flux.py``: 19 double-stream blocks, 38 single-stream
blocks, AdaLN-Zero modulation, 3-axis RoPE in the half layout (or, with
``cfg.rope_layout="interleaved"``, in the checkpoints' own pair layout:
the qk RMSNorm and the rotation then run before an attention kernel
without rope; ``set_rope_layout_`` permutes a model's q/k channels between
the two in place).

The JAX blocks run under ``nn.scan`` with stacked parameters; here they are
``nn.ModuleList``s, one module per layer (``x2i_torch.params`` unstacks the
JAX tree). The FLUX MLPs use the tanh form of gelu (flax ``nn.gelu``).
Every dense layer is ``make_linear(cfg.quantized)``: ``nn.Linear``, or a
``QuantLinear`` in w8, w8a8, w4 or w4a8. In the "quant" glue mode (w8a8
and w4a8) the inputs of the attention and MLP projections come
pre-quantized from the glue kernels K6/K7/K8 (``ops/fused_glue.py``) to
the int8 or the w4a8 GEMM, and the single block's output layer takes
``[attn, mlp]`` as two chunks, never their concatenation (in w4a8 the
two chunks are K-slices of one half-split int4 weight).

For attention distillation the model also returns each block's attention
output (the double blocks' after their out layers, the single blocks'
raw head concatenation): stacked as KD stacks, optionally per-token int8,
or turned inside each block into its KD term against a teacher's stack
(``kd_targets``), so that only scalars leave the blocks. Under
``kd_targets`` the fused glue is off, as in JAX, since its kernels have no
backward. ``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``); ``cfg.rope_in_kernel=False`` rotates q and k
before the attention call instead of inside the kernel.

LightControl's ControlNeXt residuals (``controls``, one row per double
block) are added to each double block's image stream at its end, on every
glue route, with precomputed mods and under the per-block checkpoint.

Under ``cfg.shard_activations`` and ``cfg.shard_sequence`` (JAX's
tensor- and sequence-parallel constraints) the blocks split their work
over the model's tensor axis (``set_tensor_axis``; the mesh's tensor axis
in ``X2IPipeline.with_mesh``), the glue unfused: each member runs its
block of heads and of the FFN (``parallel/tensor.py``), the row-split
layers' parts summed over the axis before their bias and gate; and/or
each member holds its block of the residual streams' tokens, the qk norm
and the rope on its rows, K and V gathered into joint order for its query
rows. Under both, the streams are gathered before the column-split
products and the row-split outputs reduce-scattered after. In every
quantized mode: in w8a8 and w4a8 a column-split layer's replicated input
is quantized once (K8) for every member and every layer that reads it,
and a row-split layer's parts are int32 accumulators at the whole row's
activation scale (``parallel/tensor.py::row_product``), so that the
sharded forward is the unsharded one bit for bit. LightControl's controls
are added to the image stream after each double block (each member's
token block of them under ``shard_sequence``). A tensor axis of one
member (or none, flags off) is the unsharded route.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from x2i_torch.core.config import ACT_QUANT_MODES, FluxConfig, quant_mode
from x2i_torch.ops.attention import attention
from x2i_torch.ops.fused_glue import (gelu_quant, ln_mod, ln_mod_quant,
                                      quant_rows)
from x2i_torch.ops.kd import kl_term, quantize_kd_tensor
from x2i_torch.ops.norms import layer_norm, rms_norm
from x2i_torch.ops.quant import make_linear
from x2i_torch.ops.ring_attention import ring_attention
from x2i_torch.ops.rope import (apply_rope_half, apply_rope_interleaved,
                                flux_rope_freqs, flux_rope_freqs_half,
                                half_layout_perm)
from x2i_torch.parallel.pipeline import pipeline_apply
from x2i_torch.parallel.tensor import (check_split, member_layers,
                                       row_product, shard_module_)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers flip_sin_to_cos=True, shift 0; f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _linear(cfg, d_in, d_out, device, bias=True):
    return make_linear(cfg.quantized, cfg.dtype, cfg.quant_impl)(
        d_in, d_out, bias=bias, device=device)


class MLPEmbedder(nn.Module):
    """linear -> silu -> linear."""

    def __init__(self, cfg, in_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.in_layer = _linear(cfg, in_dim, hidden_dim, device)
        self.out_layer = _linear(cfg, hidden_dim, hidden_dim, device)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class QKNorm(nn.Module):
    """Per-head RMSNorm scale of q or k (diffusers qk_norm='rms_norm')."""

    def __init__(self, head_dim: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(head_dim, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _norm_modulate(cfg, glue, x, shift, scale):
    """LayerNorm (no affine) + modulate: the ln_mod kernel in the "ln" glue
    mode, ln_mod_quant's (codes, row scales) in "quant", the two plain
    steps otherwise."""
    if glue == "quant":
        return ln_mod_quant(x, shift, scale, impl=cfg.quant_impl)
    if glue == "ln":
        return ln_mod(x, shift, scale)
    return _modulate(layer_norm(x), shift, scale)


def _mlp_out(cfg, glue, layer, mid):
    """gelu, then the MLP's output layer (through gelu_quant in "quant")."""
    if glue == "quant":
        return layer(gelu_quant(mid, impl=cfg.quant_impl))
    return layer(_gelu(mid))


def _attn_out(cfg, glue, layer, attn):
    if glue == "quant":
        return layer(quant_rows(attn, impl=cfg.quant_impl))
    return layer(attn)


def _rotate(cfg, x, rope):
    """x (B, S, H, D) rotated by the rope tables in ``cfg.rope_layout``."""
    if cfg.rope_layout == "interleaved":
        cos, sin = rope
        return apply_rope_interleaved(x, cos[:, None, :], sin[:, None, :])
    return apply_rope_half(x, *rope)


def _roped_attention(cfg, q, k, v, rope, qk_norm, ring_axis=None):
    """Joint attention of (B, S, H, D) q/k/v with the rope tables inside
    the kernel, or applied here first when ``cfg.rope_in_kernel`` is off
    (the qk norm is then never folded: see ``_fold_qk``). In the
    interleaved layout, and under ``cfg.ring_sequence``, the qk norm and
    the rope are applied here and the attention takes no rope; under
    ``ring_sequence`` it goes around the ring of ``ring_axis`` (JAX's
    ``_ring`` over the mesh's tensor axis), where a ring of one member (or
    none) is the ordinary attention."""
    if cfg.ring_sequence or cfg.rope_layout == "interleaved":
        if qk_norm is not None:
            qw, kw, eps = qk_norm
            q, k = rms_norm(q, qw, eps), rms_norm(k, kw, eps)
        q, k = _rotate(cfg, q, rope), _rotate(cfg, k, rope)
        if (not cfg.ring_sequence or ring_axis is None
                or ring_axis.size == 1):
            return attention(q, k, v, implementation=cfg.attention_impl)
        return ring_attention(q, k, v, ring_axis,
                              implementation=cfg.attention_impl)
    if not cfg.rope_in_kernel:
        q, k = apply_rope_half(q, *rope), apply_rope_half(k, *rope)
        rope = None
    return attention(q, k, v, implementation=cfg.attention_impl, rope=rope,
                     qk_norm=qk_norm)


def _fold_qk(cfg, glue) -> bool:
    """Whether the qk RMSNorm runs inside the attention kernel: in every
    fused glue mode, with the half-layout rope in the kernel (JAX's
    ``_roped_attention`` applies it outside otherwise)."""
    return (glue is not None and cfg.rope_in_kernel
            and cfg.rope_layout == "half")


def _block_aux(attns, kd_target, kd_tau, kd_quantize):
    """What a block hands out beside its carry: its KD terms against
    ``kd_target``, or its attention outputs (int8 pairs with
    ``kd_quantize``)."""
    if kd_target is not None:
        return tuple(kl_term(t, a, kd_tau) for t, a in zip(kd_target, attns))
    if kd_quantize:
        return tuple(quantize_kd_tensor(a) for a in attns)
    return attns


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _run_block(cfg, blk, *args, **kw):
    """One block, recomputed in the backward under ``cfg.remat``."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(blk, *args, use_reentrant=False, **kw)
    return blk(*args, **kw)


class _TensorParallel:
    """What both blocks share under ``shard_activations`` /
    ``shard_sequence``: the tensor axis, each held member's split layers
    (``members``: by local name, or None where the block's own layers are
    the member's, as in a rank's shard), and the sums over the axis."""

    tensor_axis = None               # the axis of the sharded flags
    members = None
    member_sources = None            # the whole layers the members cut

    def layer(self, i: int, name: str) -> nn.Module:
        """Held member i's part of layer ``name`` (split or whole)."""
        parts = self.members[i] if self.members else None
        return getattr(self, name) if parts is None or name not in parts \
            else parts[name]

    def check_members(self):
        if self.cfg.shard_activations and not self.members:
            raise RuntimeError("shard_activations was set after "
                               "set_tensor_axis: call it again")
        for name, src in (self.member_sources or {}).items():
            if getattr(self, name) is not src:
                raise RuntimeError(
                    f"layer {name} changed after set_tensor_axis (e.g. "
                    f"quantized): call set_tensor_axis again")

    def row_out(self, name: str, xs):
        """Row-split layer ``name`` on each held member's input features
        ``xs`` (a list): the members' parts summed over the axis (each
        member's token block of the sum under ``shard_sequence``;
        ``parallel/tensor.py::row_product``), then its bias."""
        ys = row_product(self.tensor_axis,
                         [self.layer(i, name) for i in range(len(xs))], xs,
                         scatter=self.cfg.shard_sequence)
        bias = getattr(self, name).bias
        if bias is None:
            return ys
        if isinstance(ys, list):
            return [y + bias.to(y.dtype) for y in ys]
        return ys + bias.to(ys.dtype)

    def column_in(self, x):
        """The replicated input of the held members' column-split layers:
        in w8a8 and w4a8 its codes and row scales (K8), made once for
        every member and every layer that reads it, as the layers would
        each make them (w4a8 after the cast to the layer's dtype); else
        x."""
        mode = quant_mode(self.cfg.quantized)
        if mode not in ACT_QUANT_MODES:
            return x
        if mode == "w4a8":
            x = x.to(self.cfg.dtype)
        return quant_rows(x, impl=self.cfg.quant_impl)

    def each(self, fn, *xs):
        """``fn`` on each held member's rows under ``shard_sequence``, else
        on the whole (replicated) tensors."""
        if self.cfg.shard_sequence:
            return [fn(*a) for a in zip(*xs)]
        return fn(*xs)

    def whole(self, xs):
        """The replicated input of a column-split product: the members'
        rows gathered under ``shard_sequence``."""
        return self.tensor_axis.gather(xs, 1) if self.cfg.shard_sequence \
            else xs


def _heads(x, hd):
    b, s, w = x.shape
    return x.view(b, s, w // hd, hd)


class FluxDoubleBlock(_TensorParallel, nn.Module):
    """Dual-stream MMDiT block: joint attention over cat(txt, img)."""

    ring_axis = None                 # the ring under cfg.ring_sequence

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim, hd = cfg.inner_dim, cfg.attention_head_dim
        mlp = int(dim * cfg.mlp_ratio)
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", _linear(cfg, dim, 6 * dim, device))
            for n in ("q", "k", "v", "attn_out"):
                self.add_module(f"{s}_{n}", _linear(cfg, dim, dim, device))
            for n in ("q_norm", "k_norm"):
                self.add_module(f"{s}_{n}", QKNorm(hd, cfg.qk_norm_eps,
                                                   cfg.dtype, device))
            self.add_module(f"{s}_mlp_in", _linear(cfg, dim, mlp, device))
            self.add_module(f"{s}_mlp_out", _linear(cfg, mlp, dim, device))

    def mods(self, temb):
        """The adaLN rows (img, txt), each (N, 6 * dim)."""
        t = F.silu(temb)
        return self.img_mod(t), self.txt_mod(t)

    def forward(self, hidden, encoder, temb, rope, mods=None, glue=None,
                kd_target=None, kd_tau=3.0, kd_quantize=False,
                control=None):
        """-> (hidden, encoder, aux): aux is (img_attn, txt_attn) after
        the out layers, their KD terms against kd_target = (teacher img,
        teacher txt), or int8 pairs with kd_quantize. ``control`` (B,
        S_img, dim), a LightControl branch's tokens, is added to the image
        stream at the block's end."""
        cfg = self.cfg
        heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
        mod, cmod = self.mods(temb) if mods is None else mods
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
        (c_shift_msa, c_scale_msa, c_gate_msa,
         c_shift_mlp, c_scale_mlp, c_gate_mlp) = cmod.chunk(6, dim=-1)

        img_in = _norm_modulate(cfg, glue, hidden, shift_msa, scale_msa)
        txt_in = _norm_modulate(cfg, glue, encoder, c_shift_msa, c_scale_msa)
        b, s_img, s_txt = hidden.shape[0], hidden.shape[1], encoder.shape[1]

        def heads_of(x):
            return x.view(b, -1, heads, hd)

        q, k, v = (heads_of(self.img_q(img_in)), heads_of(self.img_k(img_in)),
                   heads_of(self.img_v(img_in)))
        cq, ck, cv = (heads_of(self.txt_q(txt_in)),
                      heads_of(self.txt_k(txt_in)),
                      heads_of(self.txt_v(txt_in)))
        qk_norm = None
        if _fold_qk(cfg, glue):
            # per-row (S, D) scale tables, txt rows first: the norm itself
            # runs inside the attention kernel
            def rows(tw, iw):
                return torch.cat([tw.float().expand(s_txt, hd),
                                  iw.float().expand(s_img, hd)])
            qk_norm = (rows(self.txt_q_norm.scale, self.img_q_norm.scale),
                       rows(self.txt_k_norm.scale, self.img_k_norm.scale),
                       cfg.qk_norm_eps)
        else:
            q, k = self.img_q_norm(q), self.img_k_norm(k)
            cq, ck = self.txt_q_norm(cq), self.txt_k_norm(ck)

        # joint attention: text tokens first, then image tokens
        attn = _roped_attention(cfg, torch.cat([cq, q], 1),
                                torch.cat([ck, k], 1), torch.cat([cv, v], 1),
                                rope, qk_norm, self.ring_axis)
        attn = attn.reshape(b, s_txt + s_img, heads * hd)
        txt_attn, img_attn = attn[:, :s_txt], attn[:, s_txt:]

        img_attn = _attn_out(cfg, glue, self.img_attn_out, img_attn)
        txt_attn = _attn_out(cfg, glue, self.txt_attn_out, txt_attn)
        hidden = hidden + gate_msa[:, None, :] * img_attn
        ff_in = _norm_modulate(cfg, glue, hidden, shift_mlp, scale_mlp)
        ff = _mlp_out(cfg, glue, self.img_mlp_out, self.img_mlp_in(ff_in))
        hidden = hidden + gate_mlp[:, None, :] * ff

        encoder = encoder + c_gate_msa[:, None, :] * txt_attn
        cff_in = _norm_modulate(cfg, glue, encoder, c_shift_mlp, c_scale_mlp)
        cff = _mlp_out(cfg, glue, self.txt_mlp_out, self.txt_mlp_in(cff_in))
        encoder = encoder + c_gate_mlp[:, None, :] * cff
        if control is not None:
            hidden = hidden + control.to(hidden.dtype)
        return hidden, encoder, _block_aux((img_attn, txt_attn), kd_target,
                                           kd_tau, kd_quantize)

    def sharded(self, hidden, encoder, temb, rope, mods=None,
                member_rope=None, control=None):
        """The block over ``tensor_axis`` (the glue unfused): ``hidden``
        and ``encoder`` are each held member's token blocks (a list) under
        ``shard_sequence``, else the whole streams; ``member_rope`` there
        each held member's (text rows', image rows') rope tables;
        ``control`` LightControl's residual for the image stream in the
        same form, added at the block's end. -> (hidden, encoder) in the
        same form."""
        cfg = self.cfg
        self.check_members()
        mod, cmod = self.mods(temb) if mods is None else mods
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = mod.chunk(6, dim=-1)
        (c_shift_msa, c_scale_msa, c_gate_msa,
         c_shift_mlp, c_scale_mlp, c_gate_mlp) = cmod.chunk(6, dim=-1)

        def norm(shift, scale):
            return lambda x: _modulate(layer_norm(x), shift, scale)

        img_in = self.each(norm(shift_msa, scale_msa), hidden)
        txt_in = self.each(norm(c_shift_msa, c_scale_msa), encoder)
        if cfg.shard_activations:
            img_attn, txt_attn = self._head_attention(
                self.whole(img_in), self.whole(txt_in), rope)
        else:
            img_attn, txt_attn = self._row_attention(img_in, txt_in,
                                                     member_rope)

        def add(gate):
            return lambda x, y: x + gate[:, None, :] * y

        hidden = self.each(add(gate_msa), hidden, img_attn)
        ff = self._ffn("img", self.each(norm(shift_mlp, scale_mlp), hidden))
        hidden = self.each(add(gate_mlp), hidden, ff)
        encoder = self.each(add(c_gate_msa), encoder, txt_attn)
        cff = self._ffn("txt", self.each(norm(c_shift_mlp, c_scale_mlp),
                                         encoder))
        encoder = self.each(add(c_gate_mlp), encoder, cff)
        if control is not None:
            hidden = self.each(lambda h, c: h + c.to(h.dtype), hidden,
                               control)
        return hidden, encoder

    def _head_attention(self, img_in, txt_in, rope):
        """Each held member's heads over the whole joint sequence: its
        parts of the out layers, summed over the axis."""
        cfg, hd = self.cfg, self.cfg.attention_head_dim
        s_txt = txt_in.shape[1]
        img_in, txt_in = self.column_in(img_in), self.column_in(txt_in)
        img_xs, txt_xs = [], []
        for i in range(len(self.tensor_axis.members)):
            lyr = functools.partial(self.layer, i)
            q = self.img_q_norm(_heads(lyr("img_q")(img_in), hd))
            k = self.img_k_norm(_heads(lyr("img_k")(img_in), hd))
            v = _heads(lyr("img_v")(img_in), hd)
            cq = self.txt_q_norm(_heads(lyr("txt_q")(txt_in), hd))
            ck = self.txt_k_norm(_heads(lyr("txt_k")(txt_in), hd))
            cv = _heads(lyr("txt_v")(txt_in), hd)
            attn = _roped_attention(cfg, torch.cat([cq, q], 1),
                                    torch.cat([ck, k], 1),
                                    torch.cat([cv, v], 1), rope, None)
            attn = attn.flatten(2)
            txt_xs.append(attn[:, :s_txt])
            img_xs.append(attn[:, s_txt:])
        return (self.row_out("img_attn_out", img_xs),
                self.row_out("txt_attn_out", txt_xs))

    def _row_attention(self, img_in, txt_in, member_rope):
        """Each held member's query rows (its text rows, then its image
        rows) against K and V gathered into joint order (all text, then
        all image); the qk norm and the rope on the member's rows."""
        cfg, hd, axis = self.cfg, self.cfg.attention_head_dim, \
            self.tensor_axis
        qs, kt, ki, vt, vi = [], [], [], [], []
        for x, c, (rt, ri) in zip(img_in, txt_in, member_rope):
            q = _rotate(cfg, self.img_q_norm(_heads(self.img_q(x), hd)), ri)
            cq = _rotate(cfg, self.txt_q_norm(_heads(self.txt_q(c), hd)), rt)
            qs.append(torch.cat([cq, q], 1))
            kt.append(_rotate(cfg, self.txt_k_norm(_heads(self.txt_k(c), hd)),
                              rt))
            ki.append(_rotate(cfg, self.img_k_norm(_heads(self.img_k(x), hd)),
                              ri))
            vt.append(_heads(self.txt_v(c), hd))
            vi.append(_heads(self.img_v(x), hd))
        k = torch.cat([axis.gather(kt, 1), axis.gather(ki, 1)], 1)
        v = torch.cat([axis.gather(vt, 1), axis.gather(vi, 1)], 1)
        img_attn, txt_attn = [], []
        for q, c in zip(qs, txt_in):
            attn = attention(q, k, v, implementation=cfg.attention_impl)
            attn = attn.flatten(2)
            txt_attn.append(self.txt_attn_out(attn[:, :c.shape[1]]))
            img_attn.append(self.img_attn_out(attn[:, c.shape[1]:]))
        return img_attn, txt_attn

    def _ffn(self, stream: str, x):
        """The stream's MLP on the normed input ``x``: each member's FFN
        block, summed over the axis, or the whole MLP on each member's
        rows."""
        if not self.cfg.shard_activations:
            return [getattr(self, f"{stream}_mlp_out")(
                _gelu(getattr(self, f"{stream}_mlp_in")(t))) for t in x]
        x = self.column_in(self.whole(x))
        return self.row_out(f"{stream}_mlp_out", [
            _gelu(self.layer(i, f"{stream}_mlp_in")(x))
            for i in range(len(self.tensor_axis.members))])


class FluxSingleBlock(_TensorParallel, nn.Module):
    """Single-stream block: parallel attention + MLP with one fused output
    projection over cat(attn, mlp)."""

    ring_axis = None                 # the ring under cfg.ring_sequence

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim, hd = cfg.inner_dim, cfg.attention_head_dim
        mlp = int(dim * cfg.mlp_ratio)
        self.mod = _linear(cfg, dim, 3 * dim, device)
        self.q = _linear(cfg, dim, dim, device)
        self.k = _linear(cfg, dim, dim, device)
        self.v = _linear(cfg, dim, dim, device)
        self.q_norm = QKNorm(hd, cfg.qk_norm_eps, cfg.dtype, device)
        self.k_norm = QKNorm(hd, cfg.qk_norm_eps, cfg.dtype, device)
        self.mlp_in = _linear(cfg, dim, mlp, device)
        self.out = _linear(cfg, dim + mlp, dim, device)

    def mods(self, temb):
        return self.mod(F.silu(temb))

    def forward(self, hidden, temb, rope, mods=None, glue=None,
                kd_target=None, kd_tau=3.0, kd_quantize=False):
        """-> (hidden, aux): aux is the raw attention output (B, S, dim),
        its KD term against kd_target, or an int8 pair with kd_quantize."""
        cfg = self.cfg
        heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
        mod = self.mods(temb) if mods is None else mods
        shift, scale, gate = mod.chunk(3, dim=-1)
        x = _norm_modulate(cfg, glue, hidden, shift, scale)
        b, s = hidden.shape[:2]
        q = self.q(x).view(b, s, heads, hd)
        k = self.k(x).view(b, s, heads, hd)
        qk_norm = None
        if _fold_qk(cfg, glue):
            qk_norm = (self.q_norm.scale, self.k_norm.scale, cfg.qk_norm_eps)
        else:
            q, k = self.q_norm(q), self.k_norm(k)
        v = self.v(x).view(b, s, heads, hd)
        attn = _roped_attention(cfg, q, k, v, rope, qk_norm,
                                self.ring_axis).reshape(b, s, heads * hd)
        if glue == "quant":
            # two pre-quantized chunks, K-slices of the one output weight
            impl = cfg.quant_impl
            mlp = gelu_quant(self.mlp_in(x), impl=impl)
            out = self.out([quant_rows(attn, impl=impl), mlp])
        else:
            mlp = _gelu(self.mlp_in(x))
            out = self.out(torch.cat([attn, mlp], dim=-1))
        hidden = hidden + gate[:, None, :] * out
        kd = None if kd_target is None else (kd_target,)
        return hidden, _block_aux((attn,), kd, kd_tau, kd_quantize)[0]

    def sharded(self, hidden, temb, rope, mods=None, member_rope=None):
        """The block over ``tensor_axis`` (the glue unfused), as
        ``FluxDoubleBlock.sharded`` on the joint stream: its members'
        token blocks under ``shard_sequence`` (``member_rope`` their rope
        rows), else the whole stream. -> hidden in the same form."""
        cfg, hd = self.cfg, self.cfg.attention_head_dim
        self.check_members()
        mod = self.mods(temb) if mods is None else mods
        shift, scale, gate = mod.chunk(3, dim=-1)
        x = self.each(lambda t: _modulate(layer_norm(t), shift, scale),
                      hidden)
        if cfg.shard_activations:
            x = self.column_in(self.whole(x))
            xs = []
            for i in range(len(self.tensor_axis.members)):
                lyr = functools.partial(self.layer, i)
                q = self.q_norm(_heads(lyr("q")(x), hd))
                k = self.k_norm(_heads(lyr("k")(x), hd))
                v = _heads(lyr("v")(x), hd)
                attn = _roped_attention(cfg, q, k, v, rope, None).flatten(2)
                mlp = _gelu(lyr("mlp_in")(x))
                xs.append(torch.cat([attn, mlp], -1))
            out = self.row_out("out", xs)
        else:
            qs, ks, vs = [], [], []
            for t, r in zip(x, member_rope):
                qs.append(_rotate(cfg, self.q_norm(_heads(self.q(t), hd)), r))
                ks.append(_rotate(cfg, self.k_norm(_heads(self.k(t), hd)), r))
                vs.append(_heads(self.v(t), hd))
            axis = self.tensor_axis
            k, v = axis.gather(ks, 1), axis.gather(vs, 1)
            out = [self.out(torch.cat([
                attention(q, k, v, implementation=cfg.attention_impl)
                .flatten(2), _gelu(self.mlp_in(t))], -1))
                for q, t in zip(qs, x)]
        return self.each(lambda h, o: h + gate[:, None, :] * o, hidden, out)


class FluxTransformer2D(nn.Module):
    """Top-level DiT. ``mods_only=True`` returns every step's adaLN rows
    (``timestep`` is then the (T,) sigma vector); ``precomputed_mods``
    feeds one step's rows back in; ``return_attn_outputs`` and
    ``kd_targets`` serve the distillation trainer (see ``forward``)."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.inner_dim
        self.x_embedder = _linear(cfg, cfg.in_channels, dim, device)
        self.context_embedder = _linear(cfg, cfg.joint_attention_dim, dim,
                                        device)
        self.time_embedder = MLPEmbedder(cfg, cfg.time_embed_dim, dim, device)
        self.pooled_embedder = MLPEmbedder(cfg, cfg.pooled_projection_dim,
                                           dim, device)
        if cfg.guidance_embeds:
            self.guidance_embedder = MLPEmbedder(cfg, cfg.time_embed_dim,
                                                 dim, device)
        self.double_blocks = nn.ModuleList(
            FluxDoubleBlock(cfg, device) for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(
            FluxSingleBlock(cfg, device)
            for _ in range(cfg.num_single_layers))
        self.norm_out = _linear(cfg, dim, 2 * dim, device)
        self.proj_out = _linear(cfg, dim, cfg.patch_size ** 2
                                * cfg.in_channels, device)

    def set_ring_axis(self, axis) -> "FluxTransformer2D":
        """The ring of ``cfg.ring_sequence`` (a ``parallel/axis.py`` axis,
        e.g. a mesh's tensor axis, or None), set on every block; returns
        the model."""
        for mod in self.modules():
            if isinstance(mod, (FluxDoubleBlock, FluxSingleBlock)):
                mod.ring_axis = axis
        return self

    tensor_axis = None               # the axis of the sharded flags
    tensor_shard = None              # (member, size) of a rank's shard

    def set_tensor_axis(self, axis) -> "FluxTransformer2D":
        """The tensor axis of ``cfg.shard_activations`` and
        ``cfg.shard_sequence`` (a ``parallel/axis.py`` axis, e.g. a mesh's
        tensor axis, or None), set on every block; returns the model. Set
        it after the weights and the flags are final. Under
        ``shard_activations`` a process that holds one member of several
        (the process form) keeps only its member's shard of the split
        layers (``parallel/tensor.py::shard_module_``, in place, once);
        the one-process form cuts every member's from the whole layers
        (views where a block is contiguous). An axis of one member takes
        the unsharded route."""
        cfg = self.cfg
        split = axis is not None and axis.size > 1 and cfg.shard_activations
        local = split and len(axis.members) > 1
        if axis is not None and getattr(axis, "devices", None) is not None:
            raise NotImplementedError("the sharded DiT runs a LocalAxis on "
                                      "one device (devices=None)")
        if split:
            check_split(cfg, axis.size, self)
            if local and self.tensor_shard is not None:
                raise ValueError(f"the model holds member "
                                 f"{self.tensor_shard[0]}'s shard: the "
                                 f"one-process form needs the whole model")
            if not local and self.tensor_shard is None:
                shard_module_(self, axis.members[0], axis.size)
            elif not local and self.tensor_shard != (axis.members[0],
                                                      axis.size):
                raise ValueError(f"the model holds member "
                                 f"{self.tensor_shard[0]} of "
                                 f"{self.tensor_shard[1]}, the axis asks "
                                 f"for {axis.members[0]} of {axis.size}")
        for blk in [*self.double_blocks, *self.single_blocks]:
            blk.tensor_axis = axis
            blk.members = ([member_layers(blk, cfg, m, axis.size)
                            for m in axis.members] if local
                           else [None] if split else None)
            blk.member_sources = ({n: getattr(blk, n)
                                   for n in blk.members[0]} if local
                                  else None)
        self.tensor_axis = axis
        return self

    def _sharded_axis(self):
        """The tensor axis when the blocks split their work over it, else
        None (flags off, or an axis of one member); raises where the flags
        cannot run."""
        cfg, axis = self.cfg, self.tensor_axis
        if not cfg.sharded:
            if self.tensor_shard is not None:
                raise RuntimeError("the model holds a member's shard: "
                                   "shard_activations must stay set")
            return None
        if cfg.ring_sequence:
            raise NotImplementedError(
                "ring_sequence together with shard_activations or "
                "shard_sequence is not ported")
        if axis is None:
            raise ValueError(
                "shard_activations / shard_sequence need a tensor axis: "
                "set_tensor_axis(LocalAxis(n, 'tensor')) on one card, or "
                "X2IPipeline.with_mesh")
        return axis if axis.size > 1 else None

    def replace_config(self, **changes) -> "FluxTransformer2D":
        """Set fields of the config of this model and of every block in
        place (e.g. a trainer's ``remat``, ``rope_in_kernel`` and
        ``fused_glue`` on a serving model's weights); returns the model."""
        self.cfg = dataclasses.replace(self.cfg, **changes)
        for mod in self.modules():
            if isinstance(getattr(mod, "cfg", None), FluxConfig):
                mod.cfg = self.cfg
        return self

    def _embed(self, hidden_states, encoder_hidden_states, pooled, timestep,
               img_ids, txt_ids, guidance):
        """-> (hidden, encoder, temb, rope): the embedders' outputs and the
        rope tables of the joint sequence (text first)."""
        cfg = self.cfg
        hidden = self.x_embedder(hidden_states.to(cfg.dtype))
        encoder = self.context_embedder(encoder_hidden_states.to(cfg.dtype))
        temb = self._temb(timestep, pooled, guidance)
        freqs = (flux_rope_freqs if cfg.rope_layout == "interleaved"
                 else flux_rope_freqs_half)
        rope = freqs(torch.cat([txt_ids, img_ids]), cfg.axes_dims_rope)
        return hidden, encoder, temb, rope

    def _head(self, hidden, temb, glue):
        """AdaLayerNormContinuous (diffusers chunks SCALE first, then
        shift) and the output projection."""
        scale, shift = self.norm_out(F.silu(temb)).chunk(2, dim=-1)
        return self.proj_out(_norm_modulate(self.cfg, glue, hidden, shift,
                                            scale))

    def _temb(self, timestep, pooled, guidance):
        cfg = self.cfg
        temb = self.time_embedder(
            timestep_embedding(timestep * 1000.0, cfg.time_embed_dim)
            .to(cfg.dtype))
        temb = temb + self.pooled_embedder(pooled.to(cfg.dtype))
        if cfg.guidance_embeds:
            if guidance is None:
                raise ValueError("guidance_embeds=True requires guidance")
            temb = temb + self.guidance_embedder(
                timestep_embedding(guidance * 1000.0, cfg.time_embed_dim)
                .to(cfg.dtype))
        return temb

    def forward(self, hidden_states, encoder_hidden_states,
                pooled_projections, timestep, img_ids, txt_ids,
                guidance: Optional[torch.Tensor] = None,
                precomputed_mods: Optional[dict] = None,
                mods_only: bool = False,
                controls: Optional[torch.Tensor] = None,
                return_attn_outputs: bool = False,
                quantize_attn_outputs: bool = False,
                kd_targets: Optional[dict] = None,
                kd_temperature: float = 3.0,
                aux_layout: str = "reference"):
        """hidden_states (B, S_img, in_channels); encoder_hidden_states
        (B, S_txt, joint_dim); pooled (B, pooled_dim); timestep (B,) in
        [0, 1]; img_ids (S_img, 3); txt_ids (S_txt, 3).

        Returns the velocity (B, S_img, in_channels); with
        ``return_attn_outputs`` also the KD stacks {"double_img",
        "double_txt", "single"}, each (B, L, S, dim) in the "reference"
        ``aux_layout`` or (L, B, S, dim) in "scan", as (int8, f32 scale)
        pairs with ``quantize_attn_outputs``. With ``kd_targets`` (a
        teacher's stacks in ``aux_layout``, dense or int8 pairs) it returns
        (velocity, KD loss summed over the blocks), each block's term
        computed inside the block. ``controls`` (num_layers, B, S_img,
        dim): LightControl's residuals, row i added to double block i's
        image stream (``models/controlnext.py``)."""
        cfg = self.cfg
        if mods_only:
            batch, n_t = pooled_projections.shape[0], timestep.shape[0]
            temb = self._temb(
                timestep.repeat_interleave(batch),
                pooled_projections.repeat(n_t, 1),
                None if guidance is None else guidance.repeat(n_t))

            def per_step(rows):          # (L, T*B, X) -> (T, L, B, X)
                lyr, _, x = rows.shape
                return rows.view(lyr, n_t, batch, x).transpose(0, 1)

            dmods = [blk.mods(temb) for blk in self.double_blocks]
            return {
                "double_img": per_step(torch.stack([m[0] for m in dmods])),
                "double_txt": per_step(torch.stack([m[1] for m in dmods])),
                "single": per_step(torch.stack(
                    [blk.mods(temb) for blk in self.single_blocks]))}

        if aux_layout not in ("reference", "scan"):
            raise ValueError(f"aux_layout={aux_layout!r}")
        tensor_axis = self._sharded_axis()
        if tensor_axis is not None:
            if return_attn_outputs or kd_targets is not None:
                raise NotImplementedError(
                    "KD stacks and KD targets under shard_activations / "
                    "shard_sequence are not ported (the training half of "
                    "the flags): the sharded DiT serves, with or without "
                    "controls")
            return self._forward_sharded(
                tensor_axis, hidden_states, encoder_hidden_states,
                pooled_projections, timestep, img_ids, txt_ids, guidance,
                precomputed_mods, controls)
        # the fused glue has no backward: KD (training) paths take the
        # plain glue, as JAX's _use_fused_glue does
        glue = None if kd_targets is not None else cfg.glue
        kd_quantize = quantize_attn_outputs and kd_targets is None
        axis = 0 if aux_layout == "scan" else 1

        def layer(stack, i):             # one block's slice of a KD stack
            if isinstance(stack, tuple):
                return tuple(t.select(axis, i) for t in stack)
            return stack.select(axis, i)

        run = functools.partial(_run_block, cfg)

        hidden, encoder, temb, rope = self._embed(
            hidden_states, encoder_hidden_states, pooled_projections,
            timestep, img_ids, txt_ids, guidance)

        m, kd = precomputed_mods, kd_targets
        aux = {"double_img": [], "double_txt": [], "single": []}
        for i, blk in enumerate(self.double_blocks):
            hidden, encoder, (a_img, a_txt) = run(
                blk, hidden, encoder, temb, rope,
                None if m is None else (m["double_img"][i],
                                        m["double_txt"][i]),
                glue=glue, kd_tau=kd_temperature, kd_quantize=kd_quantize,
                kd_target=None if kd is None else (
                    layer(kd["double_img"], i), layer(kd["double_txt"], i)),
                control=None if controls is None else controls[i])
            aux["double_img"].append(a_img)
            aux["double_txt"].append(a_txt)
        joint = torch.cat([encoder, hidden], dim=1)
        for i, blk in enumerate(self.single_blocks):
            joint, a = run(blk, joint, temb, rope,
                           None if m is None else m["single"][i], glue=glue,
                           kd_tau=kd_temperature, kd_quantize=kd_quantize,
                           kd_target=None if kd is None else layer(
                               kd["single"], i))
            aux["single"].append(a)
        hidden = joint[:, encoder.shape[1]:]
        output = self._head(hidden, temb, glue)
        if kd_targets is not None:
            kl = sum(torch.stack(aux[key]).sum()
                     for key in ("double_img", "double_txt", "single"))
            return output, kl
        if return_attn_outputs:
            def stack(ys):
                if isinstance(ys[0], tuple):
                    return tuple(torch.stack(t, axis) for t in zip(*ys))
                return torch.stack(ys, axis)
            return output, {key: stack(ys) for key, ys in aux.items()}
        return output

    def _forward_sharded(self, axis, hidden_states, encoder_hidden_states,
                         pooled_projections, timestep, img_ids, txt_ids,
                         guidance, precomputed_mods, controls=None):
        """``forward``'s velocity with the blocks over ``axis``: the
        embedders and the head run whole on every member; under
        ``shard_sequence`` the streams are split into the members' token
        blocks after the embedders (text and image apart for the double
        blocks, the joint stream for the single ones; each control row
        as the image stream) and gathered before the head."""
        cfg = self.cfg
        inputs = (hidden_states, encoder_hidden_states, pooled_projections,
                  timestep, guidance, controls)
        if torch.is_grad_enabled():
            weights = any(p.requires_grad for p in self.parameters())
            if len(axis.members) == 1 and (weights or any(
                    t is not None and t.requires_grad for t in inputs)):
                raise RuntimeError(
                    "the sharded DiT over the process form of the tensor "
                    "axis has no backward (its collectives do not "
                    "differentiate); the one-process form does")
            if cfg.shard_activations and weights:
                raise NotImplementedError(
                    "training the DiT's weights under shard_activations is "
                    "not ported (the members' layers are cut from them): "
                    "freeze them (requires_grad_(False))")
            if (cfg.shard_activations
                    and quant_mode(cfg.quantized) in ACT_QUANT_MODES
                    and any(t is not None and t.requires_grad
                            for t in inputs)):
                raise NotImplementedError(
                    f"the backward of a {cfg.quantized} DiT under "
                    f"shard_activations is not ported (its row-split "
                    f"layers' int32 sums have no straight-through "
                    f"backward): serve it under torch.no_grad()")
        hidden, encoder, temb, rope = self._embed(
            hidden_states, encoder_hidden_states, pooled_projections,
            timestep, img_ids, txt_ids, guidance)
        s_txt, s_img = encoder.shape[1], hidden.shape[1]
        dbl_rope = sgl_rope = None
        if cfg.shard_sequence:
            hidden = axis.split(hidden, 1, "image tokens")
            encoder = axis.split(encoder, 1, "text tokens")
            st, si = s_txt // axis.size, s_img // axis.size

            def rows(start, n):
                return tuple(t.narrow(0, start, n) for t in rope)

            dbl_rope = [(rows(m * st, st), rows(s_txt + m * si, si))
                        for m in axis.members]
            sgl_rope = [rows(m * (st + si), st + si) for m in axis.members]
        m = precomputed_mods
        run = functools.partial(_run_block, cfg)
        for i, blk in enumerate(self.double_blocks):
            control = None if controls is None else controls[i]
            if control is not None and cfg.shard_sequence:
                control = axis.split(control, 1, "image tokens")
            hidden, encoder = run(
                blk.sharded, hidden, encoder, temb, rope,
                None if m is None else (m["double_img"][i],
                                        m["double_txt"][i]), dbl_rope,
                control)
        if cfg.shard_sequence:
            joint = axis.split(torch.cat([axis.gather(encoder, 1),
                                          axis.gather(hidden, 1)], 1), 1,
                               "joint tokens")
        else:
            joint = torch.cat([encoder, hidden], 1)
        for i, blk in enumerate(self.single_blocks):
            joint = run(blk.sharded, joint, temb, rope,
                        None if m is None else m["single"][i], sgl_rope)
        if cfg.shard_sequence:
            joint = axis.gather(joint, 1)
        return self._head(joint[:, s_txt:], temb, None)


# the q/k projections and qk-norm scales of each block, whose channels the
# rope layouts order differently
QK_LINEARS = ("q", "k", "img_q", "img_k", "txt_q", "txt_k")
QK_NORMS = ("q_norm", "k_norm", "img_q_norm", "img_k_norm", "txt_q_norm",
            "txt_k_norm")


@torch.no_grad()
def set_rope_layout_(model: FluxTransformer2D,
                     layout: str) -> FluxTransformer2D:
    """Permute ``model``'s q/k channels in place from its
    ``cfg.rope_layout`` into ``layout`` ("half" or "interleaved") and set
    the layout in its config; returns the model. The counterpart of JAX's
    ``permute_params_to_half_rope`` (from interleaved to half), and its
    inverse: the output channels of every q and k projection, within each
    head (a ``QuantLinear``'s codes, its per-channel scales and its bias;
    nn.Linear's weight rows and bias), and the qk-norm scales, by
    ``ops/rope.py::half_layout_perm``. Attention outputs are the same in
    exact arithmetic: the q.k scores do not see a permutation shared by q
    and k, and v and the outputs keep their order. Going there and back
    leaves every tensor bit for bit as it was."""
    cfg = model.cfg
    if layout not in ("half", "interleaved"):
        raise ValueError(f"rope layout {layout!r}")
    if model.tensor_shard is not None:
        raise ValueError("set the rope layout before a model is sharded")
    if layout == cfg.rope_layout:
        return model
    d = cfg.attention_head_dim
    perm = torch.from_numpy(half_layout_perm(d))
    if layout == "interleaved":
        perm = torch.argsort(perm)
    full = torch.cat([h * d + perm for h in range(cfg.num_attention_heads)])

    def take(t, index, dim):
        t.copy_(t.index_select(dim, index.to(t.device)))

    for blk in [*model.double_blocks, *model.single_blocks]:
        for name in QK_LINEARS:
            lin = getattr(blk, name, None)
            if lin is None:
                continue
            for leaf, dim in (("weight", 0), ("qweight", 0), ("pweight", 0),
                              ("bias", 0), ("scale", -1), ("mscale", -1)):
                t = getattr(lin, leaf, None)
                if isinstance(t, torch.Tensor):
                    take(t, full, dim)
        for name in QK_NORMS:
            norm = getattr(blk, name, None)
            if norm is not None:
                take(norm.scale, perm, 0)
    return model.replace_config(rope_layout=layout)


def _pad_layers(layers, n_stages: int) -> list:
    """``layers`` padded with identity layers (None) to a multiple of
    ``n_stages`` (JAX's ``_pad_layer_stack``: 19 doubles over 4 stages
    become 20)."""
    return list(layers) + [None] * (-len(layers) % n_stages)


def flux_pipeline_forward(model: FluxTransformer2D, hidden_states,
                          encoder_hidden_states, pooled_projections,
                          timestep, img_ids, txt_ids, *, axis,
                          guidance=None):
    """The DiT's forward with its block stacks pipelined over the stages of
    ``axis`` (GPipe, ``parallel/pipeline.py``), the counterpart of JAX's
    ``flux_pipeline_forward``. The embedders and the head run replicated;
    the double and the single stack each go through ``pipeline_apply``,
    one sample a microbatch, a stack that does not divide the stages
    padded with identity layers. The serving path (no controls, no KD
    outputs): the velocity equals ``model(...)`` to float precision."""
    cfg = model.cfg
    if cfg.sharded:
        raise NotImplementedError("the pipelined forward under "
                                  "shard_activations / shard_sequence is "
                                  "not ported")
    glue = cfg.glue
    hidden, encoder, temb, rope = model._embed(
        hidden_states, encoder_hidden_states, pooled_projections, timestep,
        img_ids, txt_ids, guidance)
    s_txt = encoder.shape[1]

    def micro(x):
        return [x[i:i + 1] for i in range(x.shape[0])]

    def double_stage(chunk, act):
        h, e, tb = act
        for blk in chunk:
            if blk is not None:
                h, e, _ = _run_block(cfg, blk, h, e, tb, rope, glue=glue)
        return h, e, tb

    def single_stage(chunk, act):
        x, tb = act
        for blk in chunk:
            if blk is not None:
                x, _ = _run_block(cfg, blk, x, tb, rope, glue=glue)
        return x, tb

    outs = pipeline_apply(double_stage,
                          _pad_layers(model.double_blocks, axis.size),
                          list(zip(micro(hidden), micro(encoder),
                                   micro(temb))), axis)
    outs = pipeline_apply(single_stage,
                          _pad_layers(model.single_blocks, axis.size),
                          [(torch.cat([e, h], 1), tb) for h, e, tb in outs],
                          axis)
    hidden = torch.cat([x for x, _ in outs])[:, s_txt:]
    temb = torch.cat([tb for _, tb in outs])
    return model._head(hidden, temb, glue)
