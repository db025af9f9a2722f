"""MiniCPM-o-2.6's omni encoder, the counterpart of
``x2i_tpu/models/minicpmo.py``: SigLIP NaViT (``vpm``), the 64-query
resampler, the Whisper encoder (``apm``) with its projector, and the
Qwen2 LM.

X2I never decodes with this model. The slices' resampled features and
the audio's pooled, projected features fill the token embeddings at the
host's scatter maps (``img_map`` / ``audio_map``: (B, S), the flat
feature row of each placeholder position, -1 elsewhere; built by
``data/minicpm_vision.py::bounds_to_map``), by a gather and a select on
the device, and one LM forward returns every hidden state. The LM is the
text path's (``language_model``), as ``InternVLEncoder`` holds it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from x2i_torch.core.config import MiniCPMOConfig
from x2i_torch.data.minicpm_vision import chunk_bias
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.resampler import Resampler
from x2i_torch.models.siglip import SiglipVisionTransformer
from x2i_torch.models.whisper_enc import AudioProjector, WhisperEncoder


# the host half's arrays that ``encode_images`` reads (prepare_minicpm_vision)
VISION_KEYS = ("patches", "position_ids", "patch_mask", "pos_embed")
CHUNK_FRAMES = 50             # Whisper's 1 s attention chunks, in conv frames


def slice_tensors(vision: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(vision[k], device=device)
            for k in VISION_KEYS}


def audio_tensors(mels: np.ndarray, lens: np.ndarray, device
                  ) -> Dict[str, torch.Tensor]:
    """``encode_audio``'s inputs for mel chunks (A, mels, T) with ``lens``
    (A,) valid mel frames each: the mels, the keys' mask and the 1 s chunk
    bias over the T' = (T - 1) // 2 + 1 conv frames. The mask is the
    reference's: it compares conv-frame indices with mel-frame lengths, so
    a chunk's pad conv frames below its mel length stay keys (the model was
    trained so, and JAX keeps it)."""
    t_conv = (mels.shape[2] - 1) // 2 + 1
    return {"mel": torch.as_tensor(mels, device=device),
            "frame_mask": torch.as_tensor(
                np.arange(t_conv)[None] < lens[:, None], device=device),
            "attn_bias": torch.as_tensor(chunk_bias(t_conv, CHUNK_FRAMES),
                                         device=device)}


def fill_rows(flat: torch.Tensor, feats: torch.Tensor,
              index: torch.Tensor) -> torch.Tensor:
    """Rows (N, C) of ``flat`` where ``index`` (N,) >= 0 replaced by those
    rows of ``feats``: JAX's clipped gather and select."""
    take = feats[index.clamp(0, feats.shape[0] - 1)].to(flat.dtype)
    return torch.where((index >= 0)[:, None], take, flat)


class MiniCPMOEncoder(nn.Module):
    """-> the hidden-state stack (B, L+1, S, H) for the proj.
    ``language_model``: an LM to share (the text path's), by default a
    new one of ``cfg.llm``; it is the module's ``llm``."""

    def __init__(self, cfg: MiniCPMOConfig, device=None,
                 language_model: Optional[Qwen2LM] = None):
        super().__init__()
        self.cfg = cfg
        llm = cfg.llm
        self.vpm = SiglipVisionTransformer(cfg.vision, device)
        self.resampler = Resampler(cfg.resampler_config(), device)
        self.apm = WhisperEncoder(cfg.audio, device)
        self.audio_projector = AudioProjector(
            cfg.audio.d_model, llm.hidden_size, cfg.audio_pool_step,
            llm.dtype, device)
        self.llm = language_model or Qwen2LM(llm, device)

    def encode_images(self, vision: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
        """The host half's slices (``prepare_minicpm_vision``: patches,
        position_ids, patch_mask, pos_embed) -> (N * query_num,
        llm_hidden) features, slice by slice."""
        feats = self.vpm(vision["patches"], vision["position_ids"],
                         vision["patch_mask"])
        tokens = self.resampler(feats, vision["pos_embed"],
                                vision["patch_mask"])
        return tokens.reshape(-1, tokens.shape[-1])

    def encode_audio(self, audio: Dict[str, torch.Tensor]) -> torch.Tensor:
        """mel (A, mels, T), one row per 30 s chunk; frame_mask (A, T')
        the keys to attend; attn_bias optional, the chunk bias -> (A *
        T' // pool_step, llm_hidden) pooled, projected features (a padded
        chunk's tail rows are garbage, which the audio map skips)."""
        hs = self.apm(audio["mel"], audio.get("frame_mask"),
                      audio.get("attn_bias"))
        proj = self.audio_projector(hs)
        return proj.reshape(-1, proj.shape[-1])

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                vision: Optional[Dict[str, torch.Tensor]] = None,
                audio: Optional[Dict[str, torch.Tensor]] = None,
                img_map: Optional[torch.Tensor] = None,
                audio_map: Optional[torch.Tensor] = None) -> torch.Tensor:
        embeds = self.llm.embed(input_ids)
        b, s, c = embeds.shape
        flat = embeds.reshape(b * s, c)
        if vision is not None and img_map is not None:
            flat = fill_rows(flat, self.encode_images(vision),
                             img_map.reshape(b * s))
        if audio is not None and audio_map is not None:
            flat = fill_rows(flat, self.encode_audio(audio),
                             audio_map.reshape(b * s))
        return self.llm(inputs_embeds=flat.reshape(b, s, c),
                  attention_mask=attention_mask)[0]
