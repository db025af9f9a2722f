"""Host-side video frames and X2I's sampling policy, the counterpart of
``x2i_tpu/data/video.py``: the reference samples one frame a second,
at most 64 (``uniform_sample_indices``). Frames come from ffmpeg (if it
is on the PATH), from a PIL animation (GIF, WebP, APNG), or from the
caller (PIL frames or a (T, H, W, 3) uint8 array). PIL and ffmpeg are
reached inside the functions.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np


def uniform_sample_indices(num_frames: int, fps: float,
                           sample_fps: float = 1.0,
                           max_frames: int = 64) -> List[int]:
    """encode_video's policy: sample every round(fps/sample_fps)-th frame,
    then uniform-subsample to max_frames if over."""
    step = max(int(round(fps / sample_fps)), 1)
    idx = list(range(0, num_frames, step))
    if len(idx) > max_frames:
        gap = len(idx) / max_frames
        idx = [idx[int(i * gap + gap / 2)] for i in range(max_frames)]
    return idx


def _load_pil_frames(path: str) -> Optional[List]:
    from PIL import Image, ImageSequence
    try:
        img = Image.open(path)
    except Exception:                     # noqa: BLE001
        return None
    if not getattr(img, "is_animated", False):
        return None
    frames = [f.convert("RGB").copy()
              for f in ImageSequence.Iterator(img)]
    return frames


def _load_ffmpeg_frames(path: str, sample_fps: float) -> Optional[List]:
    if shutil.which("ffmpeg") is None:
        return None
    from PIL import Image
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "f%05d.png")
        try:
            subprocess.run(
                ["ffmpeg", "-i", path, "-vf", f"fps={sample_fps}",
                 "-vframes", "64", out, "-loglevel", "error"],
                check=True, capture_output=True, timeout=300)
        except Exception:                 # noqa: BLE001
            return None
        files = sorted(os.listdir(td))
        return [Image.open(os.path.join(td, f)).convert("RGB").copy()
                for f in files]


def load_video_frames(path_or_frames, sample_fps: float = 1.0,
                      max_frames: int = 64,
                      assumed_fps: float = 24.0) -> List:
    """-> list of PIL frames, uniform-sampled per the reference policy.

    Accepts a video/animation path, a sequence of PIL images, or a
    (T, H, W, 3) uint8 array.
    """
    from PIL import Image
    if isinstance(path_or_frames, (list, tuple)):
        frames = list(path_or_frames)
    elif isinstance(path_or_frames, np.ndarray):
        frames = [Image.fromarray(f) for f in path_or_frames]
    else:
        frames = _load_ffmpeg_frames(path_or_frames, sample_fps)
        if frames is not None:
            # ffmpeg already applied fps sampling; only cap length
            return frames[:max_frames]
        frames = _load_pil_frames(path_or_frames)
        if frames is None:
            raise ValueError(
                f"cannot decode {path_or_frames!r}: no ffmpeg on PATH and "
                "not a PIL-readable animation; pass frames directly")
    idx = uniform_sample_indices(len(frames), assumed_fps, sample_fps,
                                 max_frames)
    return [frames[i] for i in idx]
