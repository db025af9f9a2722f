"""ComfyUI nodes, the counterpart of ``x2i_tpu/integrations/comfyui.py``:
loader and encode nodes that produce ComfyUI CONDITIONING,
``[[prompt_embeds, {"pooled_output": pooled}]]``, for stock FLUX sampler
nodes, and the self-describing single-file proj checkpoint.

The proj checkpoint keeps JAX's format, so that a file written by either
package loads in the other: an npz of the proj's flax param tree (float32
leaves, keys joined by ".") beside ``__config__``, the ``ProjConfig``
fields as JSON (dtypes left out).

The classes follow the ComfyUI node protocol (INPUT_TYPES, RETURN_TYPES,
FUNCTION) without importing ComfyUI; ``comfyui_plugin/`` is the shim a
ComfyUI checkout loads from its ``custom_nodes``. The loaders build on the
card unless a caller passes ``device="cpu"``; the encode node runs where
its modules lie, under ``torch.inference_mode``, and hands back tensors,
ComfyUI's own currency.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np
import torch

# the proj's configs by size, the 0_5b one among them
PROJ_SIZE_CONFIGS = {
    "0_5b": dict(in_channels=25, input_dim=896, num_heads=14, head_dim=64),
    "internvl1b": dict(in_channels=25, input_dim=896, num_heads=12,
                       head_dim=64, use_scale=True, use_cnn=False),
    "internvl4b": dict(in_channels=37, input_dim=2048, num_heads=16,
                       head_dim=128),
    "3b": dict(in_channels=37, input_dim=2048, num_heads=28, head_dim=128),
    "7b": dict(in_channels=29, input_dim=3584, num_heads=28, head_dim=128),
}

MLLM_MODELS = {"qwenvl2.5": "x2i-qwenvl2.5-7b",
               "internvl2.5": "x2i-internvl2.5-1b",
               "minicpm-o": "x2i-minicpm-o-2.6"}


def proj_config_dict(cfg) -> Dict:
    """A ``ProjConfig``'s fields for the checkpoint (dtypes left out)."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("dtype", "param_dtype")}


def save_proj_checkpoint(path: str, config: Dict, params) -> None:
    """The npz checkpoint of a proj: ``params`` is a ``Proj`` module or
    its flax param tree (nested dicts of arrays)."""
    if isinstance(params, torch.nn.Module):
        from x2i_torch.params import to_flax
        params = to_flax(params)
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(name, v)
            else:
                flat[name] = np.asarray(v)

    walk("", params)
    np.savez(path, __config__=json.dumps(config), **flat)


def load_proj_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """-> (the config dict, the flax param tree) of an npz checkpoint."""
    data = np.load(path, allow_pickle=False)
    config = json.loads(str(data["__config__"]))
    params: Dict = {}
    for key in data.files:
        if key == "__config__":
            continue
        parts = key.split(".")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return config, params


class MLLMLoader:
    """ComfyUI node: an MLLM encoder from an HF checkpoint directory (the
    family's whole encoder, its tokenizer the directory's own)."""

    RETURN_TYPES = ("MLLM",)
    FUNCTION = "load"
    CATEGORY = "X2I"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "mllm_type": (list(MLLM_MODELS),),
            "model_path": ("STRING", {"default": ""}),
        }}

    def load(self, mllm_type: str, model_path: str, device=None):
        from x2i_torch.convert import load as L
        model = MLLM_MODELS[mllm_type]
        encoder_fn, _ = L.load_mllm_encoder(
            model, model_path, L.mllm_tokenizer(model, model_path), device)
        return (encoder_fn,)


class ProjLoader:
    """ComfyUI node: the proj from a self-describing checkpoint."""

    RETURN_TYPES = ("PROJ",)
    FUNCTION = "load"
    CATEGORY = "X2I"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"proj_path": ("STRING", {"default": ""})}}

    def load(self, proj_path: str, device=None):
        from x2i_torch.core.config import ProjConfig
        from x2i_torch.models.proj import Proj
        from x2i_torch.params import load_flax
        from x2i_torch.pipeline import resolve_device
        config, params = load_proj_checkpoint(proj_path)
        proj = Proj(ProjConfig(**config), device=resolve_device(device))
        return (load_flax(proj, params),)


class MLLMEncode:
    """ComfyUI node: a prompt (and images) -> CONDITIONING."""

    RETURN_TYPES = ("CONDITIONING",)
    FUNCTION = "encode"
    CATEGORY = "X2I"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"mllm": ("MLLM",), "proj": ("PROJ",),
                             "text": ("STRING", {"multiline": True})},
                "optional": {"images": ("IMAGE_PATHS",)}}

    @torch.inference_mode()
    def encode(self, mllm, proj, text: str, images=None):
        if images:
            from PIL import Image
            images = [Image.open(p).convert("RGB") if isinstance(p, str)
                      else p for p in images]
        states = mllm({"prompt": text, "images": images or None,
                       "task": "text2image"})
        pooled, prompt_embeds = proj(states)
        return ([[prompt_embeds, {"pooled_output": pooled}]],)


class LoadImagePath:
    RETURN_TYPES = ("IMAGE_PATHS",)
    FUNCTION = "load"
    CATEGORY = "X2I"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"path": ("STRING", {"default": ""})}}

    def load(self, path: str):
        return ([path],)


class MultiImagePaths:
    """Up to 4 image paths."""

    RETURN_TYPES = ("IMAGE_PATHS",)
    FUNCTION = "load"
    CATEGORY = "X2I"

    @classmethod
    def INPUT_TYPES(cls):
        opt = {f"path{i}": ("STRING", {"default": ""}) for i in range(1, 5)}
        return {"optional": opt}

    def load(self, path1="", path2="", path3="", path4=""):
        return ([p for p in (path1, path2, path3, path4) if p],)


NODE_CLASS_MAPPINGS = {
    "X2I_MLLMLoader": MLLMLoader,
    "X2I_MLLMEncode": MLLMEncode,
    "X2I_ProjLoader": ProjLoader,
    "X2I_LoadImagePath": LoadImagePath,
    "X2I_MultiImagePaths": MultiImagePaths,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "X2I_MLLMLoader": "X2I MLLM Loader (CUDA)",
    "X2I_MLLMEncode": "X2I MLLM Encode (CUDA)",
    "X2I_ProjLoader": "X2I Proj Loader (CUDA)",
    "X2I_LoadImagePath": "X2I Load Image Path",
    "X2I_MultiImagePaths": "X2I Multi Image Paths",
}
