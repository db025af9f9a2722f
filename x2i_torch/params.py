"""Weights for the port's modules: the bridge from a flax param tree, and
random weights drawn from a ``torch.Generator``.

The bridge takes the JAX package's param trees as nested dicts of numpy
arrays and copies every leaf into the matching PyTorch parameter:

* scan-stacked layers (a leading L axis: FLUX ``double_blocks`` and
  ``single_blocks``, or ``single_blocks_{i}`` chunks, and Qwen2
  ``layers/block``, ChatTTS's ``blocks/block``) fill one module of an
  ``nn.ModuleList`` per index;
* Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
* ``QuantDense`` ``qkernel`` (in, out) int8, ``scale`` (out,) f32 and
  ``bias`` -> ``QuantLinear`` ``qweight`` (out, in), ``scale``, ``bias``;
  in w4a8 ``pkernel`` (in/2, out) -> ``pweight`` (out, in/2), ``mscale``
  (G, out), ``scale`` (out,) and ``bias``; in w4 ``pkernel``, ``scale``
  (G, out), ``pre_scale`` (in,) and ``bias`` (the leaves of
  ``quantize_tree(params, mode, group)``: the layer takes the G groups of
  its leaves, whatever group it was built with);
* ``nn.Embed`` ``embedding`` -> ``nn.Embedding.weight``;
* Conv ``kernel`` HWIO -> ``nn.Conv2d.weight`` OIHW, and a 1-D Conv's
  (k, in/groups, out) -> ``nn.Conv1d.weight`` (out, in/groups, k);
* a raw (in, out) matrix whose name starts with one of the module's
  ``flax_transposed`` prefixes (ChatTTS's weight-normed heads
  ``head_v_i``) -> the parameter in torch's (out, in);
* every other leaf (norm ``scale``/``bias``, ``cha_scale``, ``ln_scale``,
  the resampler's raw ``query`` and ``proj`` matrices) -> the parameter
  of the same name, as it is.

A vmapped tree (LightControl's ControlNeXt bank) fills one module of an
``nn.ModuleList`` per index of its leading axis (``load_flax_bank``).

The FLUX q/k channels stay in the layout the tree carries: the half-RoPE
permutation of JAX's converter, or the stored order of a tree for
``rope_layout="interleaved"``. Every parameter and buffer must be filled
exactly once and every leaf used, or the bridge raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from x2i_torch.models.resampler import Resampler
from x2i_torch.ops.quant import QuantLinear

Tree = Mapping[str, Any]
# a QuantDense's leaves by mode: the codes' leaf and the QuantLinear
# buffer it goes to transposed, (.., out) -> (out, ..); the leaves copied
# as they are (the bias apart)
_QUANT_LEAVES = {"w8": ("qkernel", "qweight", ("scale",)),
                 "w8a8": ("qkernel", "qweight", ("scale",)),
                 "w4": ("pkernel", "pweight", ("scale", "pre_scale")),
                 "w4a8": ("pkernel", "pweight", ("scale", "mscale"))}
# parameters that random_init_ draws from a normal law, with its std
RANDOM_TABLES = {"rel_bias": 1.0, "position_embedding": 0.02}


def _params(tree: Tree) -> Tree:
    return tree["params"] if "params" in tree else tree


def _slice(tree: Tree, i: int) -> Dict[str, Any]:
    return {k: (_slice(v, i) if isinstance(v, Mapping) else v[i])
            for k, v in tree.items()}


def _stack_chunks(tree: Tree, name: str) -> Tree:
    """Merge ``single_blocks_{i}`` chunk stacks back into one stack."""
    chunks = sorted((k for k in tree if k.startswith(name + "_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    if not chunks:
        return tree
    out = {k: v for k, v in tree.items() if k not in chunks}

    def cat(*subs):
        if isinstance(subs[0], Mapping):
            return {k: cat(*(s[k] for s in subs)) for k in subs[0]}
        return np.concatenate(subs, axis=0)

    out[name] = cat(*(tree[k] for k in chunks))
    return out


def _copy(param: torch.Tensor, value, name: str, filled: set):
    value = np.asarray(value)
    if value.dtype.kind not in "iu":       # int8 codes stay integers
        value = value.astype(np.float32)
    value = torch.as_tensor(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: flax shape {tuple(value.shape)} does not "
                         f"fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.dtype))
    filled.add(id(param))


def _load(module: nn.Module, tree: Tree, prefix: str, filled: set):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        child = getattr(module, key, None)
        if child is None:
            raise KeyError(f"{name}: no such parameter or module in "
                           f"{type(module).__name__}")
        if isinstance(child, nn.ModuleList):
            if set(val) == {"block"}:      # the Qwen2 scan's wrapper name
                val = val["block"]
            for i, sub in enumerate(child):
                _load(sub, _slice(val, i), f"{name}.{i}.", filled)
            lead = {np.shape(v)[0] for v in _leaves(val)}
            if lead != {len(child)}:
                raise ValueError(f"{name}: {lead} stacked layers for "
                                 f"{len(child)} modules")
        elif isinstance(child, QuantLinear):
            leaf, buf, rest = _QUANT_LEAVES[child.mode]
            _only(val, {leaf, "bias", *rest}, name)
            if child.mode in ("w4", "w4a8"):
                # the int4 group comes with the tree (``quantize_tree``'s
                # ``group``): its scales' group axis
                groups = np.shape(val["mscale" if child.mode == "w4a8"
                                      else "scale"])[-2]
                if groups != child.in_features // child.group:
                    child.set_groups_(groups)
            _copy(getattr(child, buf), np.swapaxes(val[leaf], -1, -2),
                  f"{name}.{leaf}", filled)
            for r in rest:
                _copy(getattr(child, r), val[r], f"{name}.{r}", filled)
            child.note_pre_scale_()
            if "bias" in val:
                _copy(child.bias, val["bias"], name + ".bias", filled)
        elif isinstance(child, nn.Linear):
            if "kernel" not in val:
                raise KeyError(f"{name}: leaves {sorted(val)} for a float "
                               f"Linear (quantized trees need a model "
                               f"built with cfg.quantized)")
            _copy(child.weight, np.swapaxes(val["kernel"], -1, -2),
                  name + ".kernel", filled)
            if "bias" in val:
                _copy(child.bias, val["bias"], name + ".bias", filled)
            _only(val, {"kernel", "bias"}, name)
        elif isinstance(child, (nn.Conv1d, nn.Conv2d)):
            axes = ((2, 1, 0) if isinstance(child, nn.Conv1d)
                    else (3, 2, 0, 1))
            _copy(child.weight, np.transpose(val["kernel"], axes),
                  name + ".kernel", filled)
            if child.bias is not None:
                _copy(child.bias, val["bias"], name + ".bias", filled)
            _only(val, {"kernel", "bias"} if child.bias is not None
                  else {"kernel"}, name)
        elif isinstance(child, nn.Embedding):
            _copy(child.weight, val["embedding"], name + ".embedding",
                  filled)
            _only(val, {"embedding"}, name)
        elif isinstance(child, nn.Module):
            _load(child, val, name + ".", filled)
        elif key.startswith(getattr(module, "flax_transposed", ())):
            _copy(child, np.swapaxes(val, -1, -2), name, filled)
        else:
            _copy(child, val, name, filled)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


def _only(val: Tree, keys: set, name: str):
    extra = set(val) - keys
    if extra:
        raise KeyError(f"{name}: unexpected leaves {sorted(extra)}")


def load_flax(module: nn.Module, tree: Tree) -> nn.Module:
    """Fill ``module`` from a flax param tree (numpy leaves); returns it.
    Raises when a leaf has no home or a parameter stays unfilled."""
    tree = _stack_chunks(_params(tree), "single_blocks")
    filled: set = set()
    _load(module, tree, "", filled)
    missing = [n for n, p in [*module.named_parameters(),
                              *module.named_buffers()]
               if id(p) not in filled]
    if missing:
        raise KeyError(f"parameters or buffers the flax tree did not fill: "
                       f"{missing}")
    return module


def to_flax(module: nn.Module) -> Dict[str, Any]:
    """The flax param tree of a float module of parameters, Linear and
    Conv2d layers and ``nn.ModuleList``s (stacked into a leading axis),
    float32 numpy leaves: the inverse of ``load_flax`` for such modules
    (a proj, its T5 refiner). Other layers raise."""
    def leaf(t):
        return t.detach().float().cpu().numpy()

    def tree(mod):
        out: Dict[str, Any] = {name: leaf(p) for name, p in
                               mod.named_parameters(recurse=False)}
        for name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):
                out[name] = _stack([tree(c) for c in child])
            elif isinstance(child, (nn.Linear, nn.Conv2d)):
                w = leaf(child.weight)
                out[name] = {"kernel": w.T if w.ndim == 2
                             else w.transpose(2, 3, 1, 0)}
                if child.bias is not None:
                    out[name]["bias"] = leaf(child.bias)
            elif isinstance(child, (QuantLinear, nn.Conv1d, nn.Embedding)):
                raise NotImplementedError(f"{name}: no flax tree for "
                                          f"{type(child).__name__}")
            else:
                out[name] = tree(child)
        return out

    return tree(module)


def _stack(subs):
    if isinstance(subs[0], Mapping):
        return {k: _stack([s[k] for s in subs]) for k in subs[0]}
    return np.stack(subs)


def load_flax_bank(bank: nn.Module, tree: Tree) -> nn.Module:
    """Fill a ``ControlBank`` from JAX's stacked bank (``init_control_bank``
    's vmapped tree: a leading (num_controls,) axis on every leaf; branch
    i takes slice i of each). Raises as ``load_flax`` does, and when the
    leading axis is not the bank's branch count."""
    return load_flax(bank, {"branches": _params(tree)})


def random_init_(module: nn.Module, generator: torch.Generator
                 ) -> nn.Module:
    """Random weights in place: Linear and convolution weights normal with
    std 1/sqrt(fan_in) (a QuantLinear quantizes such a weight), embeddings
    normal with std 1, as T5's relative position bias table; CLIP's
    position embeddings and the resampler's queries normal with std 0.02
    (the JAX initializers of the first two), the resampler's raw ``proj``
    matrix and ChatTTS's weight-normed heads ``head_v_i`` with std
    1/sqrt(fan_in); biases 0, every other parameter (norm
    scales, the proj's channel scale) 1 -- except norm biases, 0."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, QuantLinear):
                # a float weight drawn the same way, then quantized
                w = torch.empty((mod.out_features, mod.in_features),
                                device=mod.scale.device)
                mod.set_weight_(w.normal_(
                    0.0, 1.0 / math.sqrt(mod.in_features),
                    generator=generator))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                   generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(mod, Resampler):
                # its raw tables: the queries, and ``proj`` (x @ proj)
                mod.query.normal_(0.0, 0.02, generator=generator)
                mod.proj.normal_(0.0, 1.0 / math.sqrt(mod.proj.shape[0]),
                                 generator=generator)
            else:
                for name, p in mod.named_parameters(recurse=False):
                    if name in RANDOM_TABLES:
                        p.normal_(0.0, RANDOM_TABLES[name],
                                  generator=generator)
                    elif name.startswith("head_v_"):   # ChatTTS's heads
                        p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]),
                                  generator=generator)
                    else:
                        p.fill_(0.0 if name.endswith("bias") else 1.0)
    return module
