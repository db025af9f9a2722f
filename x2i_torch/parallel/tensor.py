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
its own). Layers split in bf16, f32 and w8 (``QuantLinear.sliced``); the
other quantized modes raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from x2i_torch.ops.quant import QuantLinear, take_ranges

# the split layers by local name (the double block's img_/txt_ pairs and
# the single block's own names)
HEAD_COLUMNS = ("img_q", "img_k", "img_v", "txt_q", "txt_k", "txt_v",
                "q", "k", "v")
MLP_COLUMNS = ("img_mlp_in", "txt_mlp_in", "mlp_in")
HEAD_ROWS = ("img_attn_out", "txt_attn_out")
MLP_ROWS = ("img_mlp_out", "txt_mlp_out")
ROWS = HEAD_ROWS + MLP_ROWS + ("out",)
SPLIT = HEAD_COLUMNS + MLP_COLUMNS + ROWS
# the leaves of a split layer: (out, in) weights, per-output vectors
MATRIX_LEAVES = ("weight", "qweight")
VECTOR_LEAVES = ("bias", "scale")

Ranges = List[Tuple[int, int]]


def check_split(cfg, size: int) -> None:
    """Raises where ``cfg``'s DiT does not split over ``size`` members:
    a head or FFN count that ``size`` does not divide (ValueError, naming
    it), a quantized mode other than w8 (NotImplementedError)."""
    if cfg.quantized not in (False, None, "w8"):
        raise NotImplementedError(
            f"quantized={cfg.quantized!r} under shard_activations: only "
            f"bf16, f32 and w8 layers split over the tensor axis (w8a8 and "
            f"w4a8 need the whole row's activation absmax, w4 its groups)")
    heads, mlp = cfg.num_attention_heads, _mlp(cfg)
    if heads % size:
        raise ValueError(f"{heads} attention heads do not split over "
                         f"{size} members of the tensor axis")
    if mlp % size:
        raise ValueError(f"{mlp} FFN channels do not split over {size} "
                         f"members of the tensor axis")


def _mlp(cfg) -> int:
    return int(cfg.inner_dim * cfg.mlp_ratio)


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


def _key_split(cfg, key: str, member: int, size: int):
    """-> (dim, ranges) of a state-dict entry that splits, else None."""
    parts = key.split(".")
    if (len(parts) != 4 or parts[0] not in ("double_blocks",
                                            "single_blocks")):
        return None
    spec = layer_split(cfg, parts[2], member, size)
    if spec is None:
        return None
    side, ranges = spec
    leaf = parts[3]
    if leaf in MATRIX_LEAVES:
        return (0 if side == "out" else 1), ranges
    if leaf in VECTOR_LEAVES and side == "out":
        return 0, ranges
    if leaf in VECTOR_LEAVES:
        return None                       # a row split keeps them whole
    raise NotImplementedError(f"{key}: no tensor-parallel split of a "
                              f"{leaf!r} leaf")


def shard_state(state: Dict[str, torch.Tensor], cfg, member: int,
                size: int) -> Dict[str, torch.Tensor]:
    """Member ``member``'s shard of a whole ``FluxTransformer2D`` state
    dict: the same keys, split tensors cut to the member's blocks (new
    storage), the others the whole state's own."""
    check_split(cfg, size)
    out = {}
    for key, t in state.items():
        spec = _key_split(cfg, key, member, size)
        out[key] = t if spec is None else take_ranges(t, *spec)
    return out


def unshard_states(states: List[Dict[str, torch.Tensor]],
                   cfg) -> Dict[str, torch.Tensor]:
    """The whole state from every member's shard, in member order
    (``shard_state``'s inverse, bit for bit)."""
    size = len(states)
    out = {}
    for key, t in states[0].items():
        spec = _key_split(cfg, key, 0, size)
        if spec is None:
            out[key] = t
            continue
        dim, ranges = spec
        pieces, off = [], 0
        for a, b in ranges:          # the r-th block of every member
            pieces += [s[key].narrow(dim, off, b - a) for s in states]
            off += b - a
        out[key] = torch.cat(pieces, dim)
    return out


@torch.no_grad()
def split_layer(layer: nn.Module, side: str, ranges: Ranges,
                copy: bool = True) -> nn.Module:
    """A block of an ``nn.Linear`` or a w8 ``QuantLinear`` (see
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
    check_split(cfg, size)
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
    """A row-split layer's part of its output: the product of ``x``
    without the bias."""
    if isinstance(layer, QuantLinear):
        return layer(x, with_bias=False)
    return nn.functional.linear(x, layer.weight)
