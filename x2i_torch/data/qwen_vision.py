"""Qwen2.5-VL's 3-D rope positions, the text branch of
``x2i_tpu/data/qwen_vision.py::get_rope_index`` (numpy, host side). The
vision branch comes with the vision tower."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def get_rope_index(input_ids: np.ndarray,
                   image_grid_thw: Optional[np.ndarray] = None,
                   video_grid_thw: Optional[np.ndarray] = None,
                   attention_mask: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(t, h, w) position ids per token of a text-only batch: every stream
    is ``cumsum(mask) - 1``, and every padded position is 1, as HF's
    ``get_rope_index`` sets them. Returns (position_ids (3, B, S),
    deltas (B,))."""
    if ((image_grid_thw is not None and len(image_grid_thw))
            or (video_grid_thw is not None and len(video_grid_thw))):
        raise NotImplementedError(
            "Qwen2.5-VL image and video positions come with the vision "
            "tower (ROADMAP.md Queue A item 4)")
    bsz, seqlen = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    pos = np.cumsum(attention_mask, axis=-1) - 1
    pos[attention_mask == 0] = 1
    pos = np.broadcast_to(pos[None], (3, bsz, seqlen)).copy()
    deltas = pos.max(axis=(0, 2)) + 1 - attention_mask.sum(-1)
    return pos, deltas
