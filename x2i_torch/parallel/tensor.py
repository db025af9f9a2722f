"""Tensor parallelism of the FLUX DiT over a ``parallel/axis.py`` axis:
the placement that JAX's ``shard_activations`` constraints leave to XLA
(``x2i_tpu/models/flux.py::_shard``), written out.

Member m of a tensor axis of ``size`` members holds

* in each double block: the img and txt q, k and v projections' output
  channels of heads [m H / size, (m + 1) H / size) (whole heads: the half
  rope layout permutes channels within a head only), ``attn_out``'s input
  features of the same heads, ``mlp_in``'s m-th block of output channels
  and ``mlp_out``'s m-th block of input features;
* in each single block: q, k, v and ``mlp_in`` as above, and the fused
  ``out`` layer's input features of both segments, attention [m D / size,
  (m + 1) D / size) and MLP [D + m F / size, D + (m + 1) F / size);
* everything else whole: the qk-norm scales, the adaLN ``mod`` layers,
  the embedders, the final layer, and the bias of every row-split layer
  (``attn_out``, ``mlp_out``, ``out``), which is added once, after the
  members' parts are summed.

``shard_state`` / ``unshard_states`` work on state dicts (a member's
shard keeps the whole state's keys); ``member_layers`` gives one member's
split layers of a block as modules, and ``shard_module_`` turns a whole
model into one member's shard in place (the process form: each rank keeps
its own). Layers split in bf16, f32 and every quantized mode
(``QuantLinear.sliced``): w4's group scales and AWQ ``pre_scale`` follow a
row-split layer's inputs, w4a8's multipliers its groups and its codes are
packed half-split again over the member's own inputs; a member's inputs
must be whole groups (an even count in w4a8), which ``check_split``
checks layer by layer.

A row-split layer's output is the sum of the members' parts
(``row_product``): in bf16, f32, w8 and w4 each member's floating product
without the bias, summed in f32 by the axis's ``psum``; in w8a8 and w4a8,
as XLA runs JAX's ``w8a8_matmul`` over sharded features, the activation
scale is the whole row's (each member's row absmax, the axis's ``pmax``,
then K8's ``max(amax, 1e-6) / 127``), each member quantizes its own
features at it and gives its int32 accumulator, the accumulators are
summed exactly over the axis, and the scales are applied once, in JAX's
order: the unsharded layer's output bit for bit. The bias is added once,
after the sum.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from x2i_torch.core.config import ACT_QUANT_MODES, quant_mode
from x2i_torch.ops.fused_glue import quant_rows_at, row_absmax
from x2i_torch.ops.int4_gemm import nibbles
from x2i_torch.ops.quant import (QuantLinear, _pack, check_group_ranges,
                                 take_inputs_w4a8, take_ranges)

# the split layers by local name (the double block's img_/txt_ pairs and
# the single block's own names)
HEAD_COLUMNS = ("img_q", "img_k", "img_v", "txt_q", "txt_k", "txt_v",
                "q", "k", "v")
MLP_COLUMNS = ("img_mlp_in", "txt_mlp_in", "mlp_in")
HEAD_ROWS = ("img_attn_out", "txt_attn_out")
MLP_ROWS = ("img_mlp_out", "txt_mlp_out")
ROWS = HEAD_ROWS + MLP_ROWS + ("out",)
SPLIT = HEAD_COLUMNS + MLP_COLUMNS + ROWS
Ranges = List[Tuple[int, int]]


def check_split(cfg, size: int, model: Optional[nn.Module] = None) -> None:
    """Raises ValueError where ``cfg``'s DiT does not split over ``size``
    members: a head or FFN count that ``size`` does not divide, naming it;
    and, given the ``model``, a quantized row-split layer whose members'
    inputs are not whole groups (an even count in w4a8), naming the layer
    and the group."""
    heads, mlp = cfg.num_attention_heads, _mlp(cfg)
    if heads % size:
        raise ValueError(f"{heads} attention heads do not split over "
                         f"{size} members of the tensor axis")
    if mlp % size:
        raise ValueError(f"{mlp} FFN channels do not split over {size} "
                         f"members of the tensor axis")
    if model is None:
        return
    for stack in ("double_blocks", "single_blocks"):
        for i, blk in enumerate(getattr(model, stack)):
            for name in ROWS:
                layer = getattr(blk, name, None)
                if isinstance(layer, QuantLinear):
                    for m in range(size):
                        layer.check_inputs(
                            layer_split(cfg, name, m, size)[1],
                            f"{stack}.{i}.{name}, member {m} of {size}")


def _mlp(cfg) -> int:
    return int(cfg.inner_dim * cfg.mlp_ratio)


def _in_features(cfg, name: str) -> int:
    """The whole input width of row-split layer ``name``."""
    dim, mlp = cfg.inner_dim, _mlp(cfg)
    return dim + mlp if name == "out" else mlp if name in MLP_ROWS else dim


def layer_split(cfg, name: str, member: int, size: int
                ) -> Optional[Tuple[str, Ranges]]:
    """How member ``member`` of ``size`` holds the block layer ``name``:
    None (whole), ("out", ranges) for a block of output channels or
    ("in", ranges) for input features, ranges in order."""
    dim, mlp = cfg.inner_dim, _mlp(cfg)
    hb, mb = dim // size, mlp // size
    heads = [(member * hb, (member + 1) * hb)]
    ffn = [(member * mb, (member + 1) * mb)]
    if name in HEAD_COLUMNS:
        return "out", heads
    if name in MLP_COLUMNS:
        return "out", ffn
    if name in HEAD_ROWS:
        return "in", heads
    if name in MLP_ROWS:
        return "in", ffn
    if name == "out":
        return "in", heads + [(dim + a, dim + b) for a, b in ffn]
    return None


def _key_split(cfg, key: str, member: int, size: int, groups=None):
    """-> (dim, ranges, packed) of a state-dict entry that splits, else
    None: the entry's ``ranges`` along ``dim`` in its own units (packed
    bytes of w4's codes, groups of the int4 scales), ``packed`` True for
    w4a8's half-split codes, whose ranges count inputs (cut from the
    unpacked codes and packed again). ``groups()`` gives the int4 group
    count of the entry's whole layer."""
    parts = key.split(".")
    if (len(parts) != 4 or parts[0] not in ("double_blocks",
                                            "single_blocks")):
        return None
    spec = layer_split(cfg, parts[2], member, size)
    if spec is None:
        return None
    side, ranges = spec
    leaf, mode = parts[3], quant_mode(cfg.quantized)
    if side == "out":
        if leaf in ("weight", "qweight", "pweight", "bias"):
            return 0, ranges, False
        if leaf in ("scale", "mscale"):
            return (1 if leaf == "mscale" or mode == "w4" else 0), ranges, \
                False
        if leaf == "pre_scale":
            return None
    else:
        if leaf in ("weight", "qweight"):
            return 1, ranges, False
        if leaf == "pweight":
            if mode == "w4a8":
                return 1, ranges, True
            return 1, [(a // 2, b // 2) for a, b in ranges], False
        if leaf == "pre_scale":
            return 0, ranges, False
        if leaf == "mscale" or (leaf == "scale" and mode == "w4"):
            group = _in_features(cfg, parts[2]) // groups()
            check_group_ranges(mode, group, ranges,
                               f"{key}, member {member} of {size}")
            return 0, [(a // group, b // group) for a, b in ranges], False
        if leaf in ("scale", "bias"):
            return None                   # a row split keeps them whole
    raise NotImplementedError(f"{key}: no tensor-parallel split of a "
                              f"{leaf!r} leaf")


def _int4_groups(cfg, state, key: str, member_state: bool, size: int):
    """-> a function giving the int4 group count of row-split ``key``'s
    whole layer, from its scale leaf in ``state`` (a member's count times
    ``size`` where ``member_state``)."""
    def groups():
        prefix = key.rsplit(".", 1)[0]
        mode = quant_mode(cfg.quantized)
        t = state[prefix + (".mscale" if mode == "w4a8" else ".scale")]
        return t.shape[0] * (size if member_state else 1)
    return groups


def _cut(t: torch.Tensor, dim: int, ranges, packed: bool) -> torch.Tensor:
    return take_inputs_w4a8(t, ranges) if packed else take_ranges(t, dim,
                                                                  ranges)


def shard_state(state: Dict[str, torch.Tensor], cfg, member: int,
                size: int) -> Dict[str, torch.Tensor]:
    """Member ``member``'s shard of a whole ``FluxTransformer2D`` state
    dict: the same keys, split tensors cut to the member's blocks (new
    storage; w4a8's codes packed half-split over the member's inputs),
    the others the whole state's own."""
    check_split(cfg, size)
    out = {}
    for key, t in state.items():
        spec = _key_split(cfg, key, member, size,
                          _int4_groups(cfg, state, key, False, size))
        out[key] = t if spec is None else _cut(t, *spec)
    return out


def unshard_states(states: List[Dict[str, torch.Tensor]],
                   cfg) -> Dict[str, torch.Tensor]:
    """The whole state from every member's shard, in member order
    (``shard_state``'s inverse, bit for bit)."""
    size = len(states)
    out = {}
    for key, t in states[0].items():
        spec = _key_split(cfg, key, 0, size,
                          _int4_groups(cfg, states[0], key, True, size))
        if spec is None:
            out[key] = t
            continue
        dim, ranges, packed = spec
        shards = [s[key] for s in states]
        if packed:                       # the members' codes, unpacked
            shards = [torch.cat(nibbles(p), 1) for p in shards]
        pieces, off = [], 0
        for a, b in ranges:          # the r-th block of every member
            pieces += [p.narrow(dim, off, b - a) for p in shards]
            off += b - a
        whole = torch.cat(pieces, dim)
        if packed:
            half = whole.shape[1] // 2
            whole = _pack(whole[:, :half], whole[:, half:])
        out[key] = whole
    return out


@torch.no_grad()
def split_layer(layer: nn.Module, side: str, ranges: Ranges,
                copy: bool = True) -> nn.Module:
    """A block of an ``nn.Linear`` or a ``QuantLinear`` (see
    ``QuantLinear.sliced``): its weights never require grad. ``copy``:
    new storage (the process form frees the whole layer), else views where
    a block is contiguous (the one-process form shares the whole model's
    storage)."""
    if isinstance(layer, QuantLinear):
        return layer.sliced(side, ranges, copy)
    if not isinstance(layer, nn.Linear):
        raise TypeError(f"no tensor-parallel split of a "
                        f"{type(layer).__name__}")
    w = take_ranges(layer.weight, 0 if side == "out" else 1, ranges, copy)
    bias = layer.bias
    if bias is not None:
        bias = (take_ranges(bias, 0, ranges, copy) if side == "out"
                else bias.clone() if copy else bias.detach())
    out = nn.Linear(w.shape[1], w.shape[0], bias=bias is not None,
                    device="meta", dtype=w.dtype)
    out.weight = nn.Parameter(w.detach(), requires_grad=False)
    if bias is not None:
        out.bias = nn.Parameter(bias.detach(), requires_grad=False)
    return out


def member_layers(block: nn.Module, cfg, member: int, size: int,
                  copy: bool = False) -> Dict[str, nn.Module]:
    """Member ``member``'s split layers of a double or single block, by
    local name."""
    out = {}
    for name in SPLIT:
        layer = getattr(block, name, None)
        if layer is not None:
            out[name] = split_layer(layer, *layer_split(cfg, name, member,
                                                        size), copy)
    return out


def shard_module_(model: nn.Module, member: int, size: int) -> nn.Module:
    """``model`` (a whole ``FluxTransformer2D``) made member ``member``'s
    shard in place: each block's split layers replaced by the member's,
    on new storage; ``model.tensor_shard`` = (member, size). Returns the
    model."""
    cfg = model.cfg
    check_split(cfg, size, model)
    if getattr(model, "tensor_shard", None) is not None:
        raise ValueError(f"the model is already member "
                         f"{model.tensor_shard[0]} of "
                         f"{model.tensor_shard[1]}")
    for blk in [*model.double_blocks, *model.single_blocks]:
        for name, layer in member_layers(blk, cfg, member, size,
                                         copy=True).items():
            setattr(blk, name, layer)
    model.tensor_shard = (member, size)
    return model


def partial_product(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A row-split layer's floating part of its output: the product of
    ``x`` without the bias."""
    if isinstance(layer, QuantLinear):
        return layer(x, with_bias=False)
    return nn.functional.linear(x, layer.weight)


def row_product(axis, layers: List[nn.Module], xs: List[torch.Tensor],
                scatter: bool = False):
    """A row-split layer's output without its bias: ``layers[i]`` is held
    member i's block of it and ``xs[i]`` that member's input features.
    The members' parts summed over ``axis`` (``psum``; with ``scatter``
    each held member's token block of the sum along dim 1,
    ``psum_scatter``): floating products in bf16, f32, w8 and w4; in
    w8a8 and w4a8 the int32 accumulators of each member's codes at the
    whole row's scale (K8's halves around the axis's ``pmax``), summed
    exactly and scaled once (see the module docstring). -> one tensor, or
    a list aligned with the held members under ``scatter``."""
    lead = layers[0]
    if getattr(lead, "mode", None) not in ACT_QUANT_MODES:
        parts = [partial_product(layer, x) for layer, x in zip(layers, xs)]
        return axis.psum_scatter(parts, 1) if scatter else axis.psum(parts)
    if lead.mode == "w4a8":           # the layer's cast before quantizing
        xs = [x.to(lead.dtype) for x in xs]
    impl, dtype = lead.impl, xs[0].dtype
    amax = axis.pmax([row_absmax(x, impl) for x in xs])
    accs = []
    for layer, x in zip(layers, xs):
        xq, a_scale = quant_rows_at(x, amax, impl)
        accs.append(layer.acc(xq))
    if not scatter:
        return lead.rescale(axis.psum(accs), a_scale, dtype)
    return [lead.rescale(acc, a, dtype) for acc, a in zip(
        axis.psum_scatter(accs, 1), axis.split(a_scale, 1))]
