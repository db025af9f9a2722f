"""Checkpoint conversion command line, the counterpart of
``x2i_tpu/convert/cli.py``: convert a released checkpoint once into the
port's own format, so that serving reads no safetensors plan at startup.

  python -m x2i_torch.convert.cli flux --src <diffusers_dir> --dst out/flux
  python -m x2i_torch.convert.cli vae  --src <diffusers_dir> --dst out/vae
  python -m x2i_torch.convert.cli mllm --model x2i-internvl2.5-1b \
      --src <hf_dir> --dst out/mllm
  python -m x2i_torch.convert.cli proj --model x2i-internvl2.5-1b \
      --src proj.bin --dst out/proj
  python -m x2i_torch.convert.cli t5   --src <t5_dir> --dst out/t5
  python -m x2i_torch.convert.cli clip --src <clip_dir> --dst out/clip
  (--quantize w8|w8a8|w4 stores the DiT's int8 or int4 codes and scales)

Each kind is loaded as ``convert/load.py`` loads it (the directory's own
config files first, the registry entry of ``--model`` where one is
absent; the MLLM directory's tokenizer gives InternVL's
``<IMG_CONTEXT>`` id), on ``--device`` (``cuda`` by default; ``cpu`` for
the CPU), and the module's ``state_dict`` is saved as CPU tensors.

The format differs from JAX's on purpose: JAX writes an orbax tree; here
``save_native`` writes the state dict (quantized codes and scales
included) with ``torch.save`` to ``dst/state.pt``, and ``load_native``
reads it back with ``weights_only=True``, as ``core/checkpointing.py``
reads its states. A module of the same config takes it with
``load_state_dict``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

STATE = "state.pt"


def save_native(path: str, module) -> None:
    """``module``'s state dict as CPU tensors into ``path/state.pt``,
    written to a temporary file and renamed."""
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE))


def load_native(path: str) -> Dict[str, torch.Tensor]:
    """The state dict ``save_native`` wrote into ``path``, on the CPU."""
    return torch.load(os.path.join(path, STATE), map_location="cpu",
                      weights_only=True)


def _subdir(src: str, name: str) -> str:
    sub = os.path.join(src, name)
    return sub if os.path.isdir(sub) else src


def convert(kind: str, src: str, model: str = "x2i-internvl2.5-1b",
            quantize=None, device=None):
    """The module of ``kind`` filled from ``src`` on ``device``, the DiT
    quantized in place with ``quantize``."""
    from x2i_torch.convert import load as L
    from x2i_torch.convert import torch_models as T
    from x2i_torch.convert.hf_config import (flux_config_from_dir,
                                             proj_config_from_sd,
                                             vae_config_from_dir)
    from x2i_torch.core.config import MODEL_REGISTRY
    from x2i_torch.models.flux import FluxTransformer2D
    from x2i_torch.models.proj import Proj
    from x2i_torch.models.vae import AutoencoderKL
    from x2i_torch.ops.quant import quantize_module_
    from x2i_torch.pipeline import resolve_device

    dev = resolve_device(device)
    spec = MODEL_REGISTRY[model]
    if kind == "flux":
        cfg = flux_config_from_dir(src, base=spec.flux) or spec.flux
        module = L._build(FluxTransformer2D, cfg, dev)
        T.fill_module(module, L.load_safetensors_dir(
            _subdir(src, "transformer")), T.flux_plan(cfg))
        if quantize:
            quantize_module_(module, quantize)
    elif kind == "vae":
        cfg = vae_config_from_dir(src) or spec.vae
        module = L._build(AutoencoderKL, cfg, dev)
        T.fill_module(module, L.load_safetensors_dir(_subdir(src, "vae")),
                      T.vae_plan(cfg))
    elif kind == "mllm":
        _, module, _ = L.load_mllm(model, src, L.mllm_tokenizer(model, src),
                                   dev)
    elif kind == "proj":
        sd = {k.removeprefix("module."): v
              for k, v in L.load_torch_bin(src).items()}
        cfg = proj_config_from_sd(sd, base=spec.proj)
        module = L._build(Proj, cfg, dev)
        T.fill_module(module, sd.items(), T.proj_plan(cfg, sd))
    elif kind == "t5":
        module, _ = L.load_t5(src, dev)
    elif kind == "clip":
        module, _ = L.load_clip_text(src, dev)
    else:
        raise ValueError(f"kind={kind!r}")
    return module


def main(argv=None) -> int:
    p = argparse.ArgumentParser("x2i_torch.convert")
    p.add_argument("kind", choices=("flux", "vae", "mllm", "proj",
                                    "t5", "clip"))
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--model", default="x2i-internvl2.5-1b",
                   help="registry name (for flux/mllm/proj configs)")
    p.add_argument("--quantize", choices=("w8", "w8a8", "w4"), default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    module = convert(args.kind, args.src, args.model, args.quantize,
                     args.device)
    save_native(args.dst, module)
    n = sum(t.numel() for t in module.state_dict().values())
    print(f"converted {args.kind}: {n / 1e6:.1f}M params -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
